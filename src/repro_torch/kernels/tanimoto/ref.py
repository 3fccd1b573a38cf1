"""Plain PyTorch version of the ``tanimoto`` top-k kernel.

Batched Tanimoto top-k over packed fingerprints, the same function as the
reference package's ``tanimoto_topk_ref``, bit for bit:

* fingerprints are ``(·, W)`` uint32 bit-planes, ``W`` words per row;
* ``c = Σ popcount(q & d)`` (intersection), ``u = |q| + |d| − c`` (union);
* ``score = float32(c) / float32(u)`` (IEEE division of two small exact
  integers), and ``0.0`` when ``u == 0``;
* order ``(score desc, row asc)``: equal scores keep the earlier row;
* fewer than ``k`` rows pad the tail with ``(-1.0, -1)``.

PyTorch on the CPU has no uint32 ``+``, ``>>``, ``<`` and no popcount, so,
as in ``hash_mix/ref.py``, the words are widened to int64 through an int32
view (values in ``[0, 2**32)``) and counted with a SWAR popcount.
``torch.topk`` does not keep ties in row order, so the running top-k is
merged as the reference merges it: a stable sort by row, then a stable
sort by ``-score``.  The database streams in ``db_chunk``-row blocks, so
the intermediate stays ``(Q, db_chunk)`` whatever the plane's size.  Runs
on any device; the CPU tests use it, and on the card it is the yardstick
the CUDA kernel is held to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..hash_mix.ref import from_u32

__all__ = [
    "PAD_INDEX",
    "PAD_SCORE",
    "row_counts",
    "tanimoto_scores_ref",
    "tanimoto_topk_ref",
]

PAD_SCORE = -1.0
PAD_INDEX = -1
_PAD_ROW = 2**31 - 1  # running-list row of a pad: after every real row

# database rows scored per block: bounds the (Q, N) intermediate, as the
# reference's _DB_CHUNK does
_DB_CHUNK = 65_536
# (query, row, word) triples popcounted per step: all W words of a row tile
# in one pass, so a small batch costs a dozen tensor ops per tile, not a
# dozen per word
_TILE_ELEMS = 1 << 24


def _check_plane(fps: torch.Tensor, name: str) -> torch.Tensor:
    if fps.dtype != torch.uint32 or fps.ndim != 2:
        raise ValueError(
            f"{name} must be (N, W) uint32, got {tuple(fps.shape)} {fps.dtype}"
        )
    return fps.contiguous()


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in ``[0, 2**32)``."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def row_counts(fps: torch.Tensor) -> torch.Tensor:
    """``(N,)`` int32 set-bit count of each ``(N, W)`` uint32 row."""
    fps = _check_plane(fps, "fps")
    return _popcount(from_u32(fps)).sum(dim=1).to(torch.int32)


def _counts(fps: torch.Tensor, counts: Optional[torch.Tensor]) -> torch.Tensor:
    if counts is None:
        return row_counts(fps).to(torch.int64)
    return counts.to(device=fps.device, dtype=torch.int64)


def tanimoto_scores_ref(
    q_fps: torch.Tensor,
    db_fps: torch.Tensor,
    q_counts: Optional[torch.Tensor] = None,
    db_counts: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense ``(Q, N)`` float32 Tanimoto matrix, a row tile at a time."""
    q_fps = _check_plane(q_fps, "q_fps")
    db_fps = _check_plane(db_fps, "db_fps")
    if q_fps.shape[1] != db_fps.shape[1]:
        raise ValueError(
            f"word width mismatch: queries {q_fps.shape[1]} vs "
            f"database {db_fps.shape[1]}"
        )
    qc = _counts(q_fps, q_counts)
    dc = _counts(db_fps, db_counts)
    (qn, w), n = q_fps.shape, db_fps.shape[0]
    qv = from_u32(q_fps)[:, None, :]
    dv = from_u32(db_fps)
    inter = torch.empty((qn, n), dtype=torch.int64, device=q_fps.device)
    tile = max(1, _TILE_ELEMS // max(1, qn * w))
    for lo in range(0, n, tile):
        hi = min(lo + tile, n)
        inter[:, lo:hi] = _popcount(qv & dv[None, lo:hi, :]).sum(dim=2)
    union = qc[:, None] + dc[None, :] - inter
    score = inter.to(torch.float32) / union.clamp_min(1).to(torch.float32)
    return torch.where(union > 0, score, torch.zeros_like(score))


def _merge_running(
    run_s: torch.Tensor,
    run_i: torch.Tensor,
    blk_s: torch.Tensor,
    blk_i: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a score block into the running ``(Q, k)`` top-k: a stable sort
    by row, then a stable sort by ``-score`` (== lexsort on
    ``(-score, row)``)."""
    k = run_s.shape[1]
    all_s = torch.cat([run_s, blk_s], dim=1)
    all_i = torch.cat([run_i, blk_i], dim=1)
    order = torch.sort(all_i, dim=1, stable=True).indices
    all_s = torch.gather(all_s, 1, order)
    all_i = torch.gather(all_i, 1, order)
    order = torch.sort(-all_s, dim=1, stable=True).indices[:, :k]
    return torch.gather(all_s, 1, order), torch.gather(all_i, 1, order)


def tanimoto_topk_ref(
    q_fps: torch.Tensor,
    db_fps: torch.Tensor,
    k: int,
    q_counts: Optional[torch.Tensor] = None,
    db_counts: Optional[torch.Tensor] = None,
    db_chunk: int = _DB_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-k: ``(scores (Q, k) float32, rows (Q, k) int32)``.

    ``q_counts`` / ``db_counts`` are the rows' set-bit counts (computed
    when omitted).  Streams the database in ``db_chunk``-row blocks and
    merges each into the running top-k, as the reference does.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    q_fps = _check_plane(q_fps, "q_fps")
    db_fps = _check_plane(db_fps, "db_fps")
    if q_fps.shape[1] != db_fps.shape[1]:
        raise ValueError(
            f"word width mismatch: queries {q_fps.shape[1]} vs "
            f"database {db_fps.shape[1]}"
        )
    dev = q_fps.device
    qn, n = q_fps.shape[0], db_fps.shape[0]
    qc = _counts(q_fps, q_counts)
    dc = _counts(db_fps, db_counts)
    run_s = torch.full((qn, k), PAD_SCORE, dtype=torch.float32, device=dev)
    run_i = torch.full((qn, k), _PAD_ROW, dtype=torch.int64, device=dev)
    for lo in range(0, n, db_chunk):
        hi = min(lo + db_chunk, n)
        blk_s = tanimoto_scores_ref(
            q_fps, db_fps[lo:hi], q_counts=qc, db_counts=dc[lo:hi]
        )
        blk_i = torch.arange(lo, hi, dtype=torch.int64, device=dev)
        run_s, run_i = _merge_running(
            run_s, run_i, blk_s, blk_i[None, :].expand(qn, hi - lo)
        )
    pad = run_s < 0.0
    rows = torch.where(pad, torch.full_like(run_i, PAD_INDEX), run_i)
    scores = torch.where(pad, torch.full_like(run_s, PAD_SCORE), run_s)
    return scores, rows.to(torch.int32)
