"""Public entry point for ``tanimoto``.

``tanimoto_topk(q_fps, db_fps, k)`` — batched Tanimoto top-k of ``(Q, W)``
uint32 query fingerprints against an ``(N, W)`` uint32 plane:
``(scores (Q, k) float32, rows (Q, k) int32)`` ordered by ``(score desc,
row asc)`` with ``(-1.0, -1)`` pads.  A CUDA tensor launches the CUDA
kernel; a CPU tensor runs the plain PyTorch version.  A CUDA tensor never
falls back to the plain version.

``tanimoto_topk_host(q_fps, db_fps, k)`` is the reference's cache-blocked
host backend, NumPy in and NumPy out, byte-identical to the plain version:
what the store's ``probe="host"`` runs over the mmap'd plane.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .kernel import tanimoto_topk_cuda
from .ref import PAD_INDEX, PAD_SCORE, tanimoto_topk_ref

__all__ = ["tanimoto_topk", "tanimoto_topk_host"]

# database rows per inner scoring tile on the host path: the (Q, tile)
# uint64/int32 working set stays L2-resident instead of streaming a
# (Q, N) intermediate through main memory per fingerprint word
_HOST_TILE = 1024
# rows per outer top-k merge block (bounds peak memory to (Q, chunk) f32)
_HOST_CHUNK = 65_536


def tanimoto_topk(
    q_fps: torch.Tensor,
    db_fps: torch.Tensor,
    k: int,
    q_counts: Optional[torch.Tensor] = None,
    db_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, rows)``; see kernel/ref."""
    if q_fps.device.type == "cuda":
        return tanimoto_topk_cuda(q_fps, db_fps, k, q_counts, db_counts)
    if q_fps.device.type == "cpu" and db_fps.device.type == "cpu":
        return tanimoto_topk_ref(q_fps, db_fps, k, q_counts, db_counts)
    raise ValueError(
        f"tanimoto_topk: unsupported devices {q_fps.device} / {db_fps.device}"
    )


def _check_plane_np(fps: np.ndarray, name: str) -> np.ndarray:
    fps = np.ascontiguousarray(fps, dtype=np.uint32)
    if fps.ndim != 2:
        raise ValueError(f"{name} must be (N, W) uint32, got {fps.shape}")
    return fps


def _merge_running_np(run_s: np.ndarray, run_i: np.ndarray, blk_s: np.ndarray,
                      blk_i: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fold a score block into the running ``(Q, k)`` top-k: a stable sort
    by row, then a stable sort by ``-score`` (== lexsort on ``(-score,
    row)``), as the plain version merges."""
    k = run_s.shape[1]
    all_s = np.concatenate([run_s, blk_s], axis=1)
    all_i = np.concatenate([run_i, blk_i], axis=1)
    order = np.argsort(all_i, axis=1, kind="stable")
    all_s = np.take_along_axis(all_s, order, axis=1)
    all_i = np.take_along_axis(all_i, order, axis=1)
    order = np.argsort(-all_s, axis=1, kind="stable")[:, :k]
    return (np.take_along_axis(all_s, order, axis=1),
            np.take_along_axis(all_i, order, axis=1))


def _chunk_topk(blk: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact ``(score desc, column asc)`` top-k of one ``(Q, M)`` block.

    ``argpartition`` (introselect, O(M)) finds the k-th score per row.
    Partitioning alone breaks boundary ties arbitrarily, so the selection
    is completed exactly: every column strictly above the threshold is in,
    and the remaining slots fill with the *lowest* columns at the
    threshold, the first-seen-winner order a stable sort produces."""
    qn, m = blk.shape
    if m <= k:
        order = np.argsort(-blk, axis=1, kind="stable")
        return np.take_along_axis(blk, order, axis=1), order.astype(np.int32)
    part = np.argpartition(-blk, k - 1, axis=1)[:, :k]
    thr = np.take_along_axis(blk, part, axis=1).min(axis=1)
    out_s = np.empty((qn, k), dtype=np.float32)
    out_i = np.empty((qn, k), dtype=np.int32)
    for r in range(qn):
        row = blk[r]
        above = np.nonzero(row > thr[r])[0]
        at = np.nonzero(row == thr[r])[0][: k - above.size]
        cols = np.concatenate([above, at]).astype(np.int32)
        scores = row[cols]
        # k elements: the stable sort keeps ascending columns per score
        order = np.argsort(-scores, kind="stable")
        out_s[r] = scores[order]
        out_i[r] = cols[order]
    return out_s, out_i


def tanimoto_topk_host(
    q_fps: np.ndarray,
    db_fps: np.ndarray,
    k: int,
    q_counts: Optional[np.ndarray] = None,
    db_counts: Optional[np.ndarray] = None,
    db_chunk: int = _HOST_CHUNK,
    tile: int = _HOST_TILE,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cache-blocked host backend: ``(scores (Q, k) float32, rows (Q, k)
    int32)`` as NumPy arrays, byte-identical to ``tanimoto_topk_ref``.

    The database streams in ``db_chunk``-row blocks merged into the
    running top-k; each block's scores come from an L2-tiled scorer (the
    words viewed two at a time as uint64, each ``(Q, tile)`` popcount
    accumulated in preallocated buffers, the float32 division landing
    tile-wise into the block), and each block's top-k from
    :func:`_chunk_topk`.  Same int32 counts, same float32 division, same
    ``(score desc, row asc)`` order as the plain version.  A plane of an
    odd number of words has no uint64 view and runs the plain version."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    q_fps = _check_plane_np(q_fps, "q_fps")
    db_fps = _check_plane_np(db_fps, "db_fps")
    if q_fps.shape[1] != db_fps.shape[1]:
        raise ValueError(
            f"word width mismatch: queries {q_fps.shape[1]} vs "
            f"database {db_fps.shape[1]}"
        )
    qn, n_words = q_fps.shape
    n_db = db_fps.shape[0]
    if qn == 0 or n_db == 0:
        return (np.full((qn, k), PAD_SCORE, dtype=np.float32),
                np.full((qn, k), PAD_INDEX, dtype=np.int32))
    if n_words % 2:
        scores, rows = tanimoto_topk_ref(
            torch.from_numpy(q_fps), torch.from_numpy(db_fps), k,
            q_counts=None if q_counts is None else torch.from_numpy(
                np.ascontiguousarray(q_counts, dtype=np.int32)),
            db_counts=None if db_counts is None else torch.from_numpy(
                np.ascontiguousarray(db_counts, dtype=np.int32)),
            db_chunk=db_chunk)
        return scores.numpy(), rows.numpy()
    from ...core.fingerprint import popcount_u32  # core imports this module

    qc = (popcount_u32(q_fps).sum(axis=1, dtype=np.int32)
          if q_counts is None else np.asarray(q_counts, dtype=np.int32))
    dc = (popcount_u32(db_fps).sum(axis=1, dtype=np.int32)
          if db_counts is None else np.asarray(db_counts, dtype=np.int32))
    q64 = q_fps.view(np.uint64)
    db64 = db_fps.view(np.uint64)
    w64 = q64.shape[1]
    run_s = np.full((qn, k), PAD_SCORE, dtype=np.float32)
    run_i = np.full((qn, k), np.iinfo(np.int32).max, dtype=np.int32)
    anded = np.empty((qn, tile), dtype=np.uint64)
    counts = np.empty((qn, tile), dtype=np.uint8)
    inter = np.empty((qn, tile), dtype=np.int32)
    for lo in range(0, n_db, db_chunk):
        hi = min(lo + db_chunk, n_db)
        blk = np.zeros((qn, hi - lo), dtype=np.float32)
        for tlo in range(lo, hi, tile):
            thi = min(tlo + tile, hi)
            m = thi - tlo
            t, c, x = anded[:, :m], counts[:, :m], inter[:, :m]
            np.bitwise_and(q64[:, 0, None], db64[None, tlo:thi, 0], out=t)
            np.bitwise_count(t, out=c)
            x[:] = c
            for w in range(1, w64):
                np.bitwise_and(q64[:, w, None], db64[None, tlo:thi, w], out=t)
                np.bitwise_count(t, out=c)
                x += c
            union = qc[:, None] + dc[None, tlo:thi] - x
            np.divide(x.astype(np.float32), union.astype(np.float32),
                      out=blk[:, tlo - lo:thi - lo], where=union > 0)
        blk_s, blk_i = _chunk_topk(blk, k)
        run_s, run_i = _merge_running_np(run_s, run_i, blk_s, blk_i + lo)
    run_i = np.where(run_s < 0.0, PAD_INDEX, run_i).astype(np.int32, copy=False)
    run_s = np.where(run_s < 0.0, PAD_SCORE, run_s).astype(np.float32, copy=False)
    return run_s, run_i
