"""CUDA wrapper for ``tanimoto`` (source: ``src/repro_torch/csrc/tanimoto.cu``).

Replaces the Pallas kernel ``tanimoto_blocks_pallas`` / ``_tanimoto_kernel``
of ``src/repro/kernels/tanimoto/kernel.py`` (wrapped there by
``tanimoto_topk_pallas``).  What bounds it on an H100: the operations —
``Q * N * W`` population counts, which the card retires at 16 per clock per
SM, take longer than reading the ``N * (4W + 4)`` bytes of the plane.  The
top-k has to cost little beside them at every k.

Design: every candidate is one 64-bit key, ``score bits << 32 |
(0x7FFFFFFF - row)`` (:func:`~.ref.pack_keys`), so that a larger key is a
better candidate.  :func:`plan` picks one of two routes before the launch:

* ``"filter"`` (``k < N`` and ``k <= 8,192``): stage 1 gives a block of 8
  warps ``qpb`` queries and a slice of rows; a row enters a query's buffer
  only if its key beats the query's threshold, and a full buffer is sorted
  and folded into the kept best ``width`` keys, which raises the threshold.
  The slices share their thresholds through device memory.  Stage 2 merges
  the slices' sorted runs, a block per query.  Slices are bounded so that
  ``slices * k <= N / 8`` (the first k rows of a slice all enter).
* ``"sort"`` (``k >= N`` or ``k > 8,192``): every key of a chunk of queries
  goes to scratch and is sorted (bitonic), and the first k are written.

What was dropped (the first design): a sorted list per (query, warp) with one
shifting insertion per candidate, slices sized only to fill the card, a
k-round serial merge, and insertion into device memory for a large k: at
4,194,304 rows and k = 1,024 that cost 64x the bound.  Every comparison is
on the key, so the result is bit-exact with the plain version whatever the
slicing.  See the source for the details.

Any ``k >= 1`` is answered, as the reference answers it (``k > N`` pads
with ``(-1.0, -1)``).  Rows are int32, so the plane has fewer than
``2**31 - 1`` rows.

``tanimoto_topk_cuda.launches`` counts the calls that launched the kernels
(thread-safe): one a call, whatever the route.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ..build import count_launch, load
from .ref import PAD_INDEX, PAD_SCORE, row_counts

__all__ = ["Plan", "filter_smem", "plan", "tanimoto_topk_cuda"]

_FRESH = 512                # kMinFresh: fresh keys a query's buffer holds,
_MAX_FRESH = 4096           # and up to this for kept lists of 512 keys and up
_QPB = (8, 4, 2, 1)         # queries per block the source is built for
_SMEM_LIMIT = 232_448       # dynamic shared memory a block may use (sm_90)
_FILTER_K_MAX = 8192        # largest k of the filter route: its stage 2
                            # holds two sorted lists of 8,192 keys
_FILL_SHARE = 8             # slices * k <= N / 8
_MIN_SLICE_ROWS = 1024      # a slice is at least 4 rounds of its block
_TARGET_BLOCKS = 132 * 16   # filter blocks to aim for: 16 per SM of an H100
_MERGE_SMEM = 1 << 17       # stage 2: lists of `width` keys in 128 KB
_SORT_CHUNK = 8192          # kSortChunk: keys a sort block holds
_SCRATCH_BYTES = 1 << 30    # sort route: keys of at least one query
_MAX_GRID_Y = 65_535        # queries a sort pass launches side by side

_FN = None


class Plan(NamedTuple):
    """One launch's plan.  ``route`` "filter": ``qpb`` queries a block,
    ``slices`` slices of ``rows_per_slice`` rows, kept lists of ``width``
    keys (a power of 2 >= k), buffers of ``fresh`` keys, stage 2 folding
    ``slots`` lists at a time.
    ``route`` "sort": ``width`` keys a query (a power of 2 >= N),
    ``query_chunk`` queries a pass.  ``smem``: the largest dynamic shared
    memory a block of the plan uses; ``scratch_bytes``: device scratch."""

    route: str
    qpb: int
    slices: int
    rows_per_slice: int
    width: int
    fresh: int
    slots: int
    query_chunk: int
    smem: int
    scratch_bytes: int


def _fn():
    global _FN
    if _FN is None:
        f = load("tanimoto").tanimoto_topk_launch
        f.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
        )
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def filter_smem(qpb: int, w: int, width: int, fresh: int = _FRESH) -> int:
    """Dynamic shared memory of a filter block (``filter_smem`` of the
    source): query words, then kept and fresh keys, thresholds, the
    buffers' fill and the queries' bit counts."""
    return _cdiv(qpb * w * 4, 16) * 16 + qpb * (width + fresh) * 8 + qpb * 16


def plan(nq: int, n: int, w: int, k: int) -> Plan:
    """The route and shapes of one launch (see the module docstring).

    Filter: queries a block, the most of 8, 4, 2, 1 that the batch fills
    and whose block leaves room for two on an SM; with kept lists of 512
    keys and up, the largest buffer (up to 4,096 keys) that still does, so
    that a large k folds less often.  Slices: enough blocks to fill the
    card (16 per SM), but ``slices * k <= N / 8`` and at least 1,024 rows a
    slice.  Sort: the whole plane's keys of as many queries as 1 GiB holds
    (at least one).
    """
    if 4 * w + filter_smem(1, 0, 32) > _SMEM_LIMIT:
        raise ValueError(f"W={w} words of queries do not fit shared memory")
    if k < n and k <= _FILTER_K_MAX:
        width = max(32, _pow2(k))
        fits = [c for c in _QPB if (c <= nq or c == 1)
                and filter_smem(c, w, width) <= _SMEM_LIMIT]
        if not fits:
            raise ValueError(f"W={w}, k={k}: no filter block fits shared memory")
        budget = _SMEM_LIMIT // 2
        qpb = next((c for c in fits if filter_smem(c, w, width) <= budget), None)
        if qpb is None:
            qpb, budget = fits[-1], _SMEM_LIMIT
        fresh = _FRESH
        while (width >= 512 and fresh < _MAX_FRESH
               and filter_smem(qpb, w, width, 2 * fresh) <= budget):
            fresh *= 2
        groups = _cdiv(nq, qpb)
        slices = max(1, min(_cdiv(_TARGET_BLOCKS, groups),
                            n // (_FILL_SHARE * k),
                            n // _MIN_SLICE_ROWS))
        slots = 2
        while slots < slices and 2 * slots * width * 8 <= _MERGE_SMEM:
            slots *= 2
        smem = max(filter_smem(qpb, w, width, fresh), slots * width * 8)
        return Plan("filter", qpb, slices, _cdiv(n, slices), width, fresh, slots,
                    nq, smem, 8 * nq * (1 + slices * k))
    width = max(2, _pow2(n))
    chunk = min(nq, _MAX_GRID_Y, max(1, _SCRATCH_BYTES // (8 * width)))
    smem = max(4 * w, 8 * min(width, _SORT_CHUNK))
    return Plan("sort", 1, 1, n, width, 0, 0, chunk, smem, 8 * chunk * width)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, dev) -> None:
    if t.dtype != dtype or t.ndim != ndim:
        raise TypeError(
            f"{name} must be {ndim}-D {dtype}, got {tuple(t.shape)} {t.dtype}"
        )
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the queries on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def tanimoto_topk_cuda(
    q_fps: torch.Tensor,
    db_fps: torch.Tensor,
    k: int,
    q_counts: Optional[torch.Tensor] = None,
    db_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Q, W)`` uint32 queries against an ``(N, W)`` uint32 plane, on one
    CUDA device → ``(scores (Q, k) float32, rows (Q, k) int32)``.

    ``q_counts`` / ``db_counts`` are the rows' ``(Q,)`` / ``(N,)`` int32
    set-bit counts (the store passes its ``fpcounts`` sidecar); when
    omitted they are computed with :func:`~.ref.row_counts`.
    """
    dev = q_fps.device
    if dev.type != "cuda":
        raise ValueError(f"tanimoto_topk_cuda needs CUDA tensors, got {dev}")
    _check("q_fps", q_fps, torch.uint32, 2, dev)
    _check("db_fps", db_fps, torch.uint32, 2, dev)
    (qn, w), n = q_fps.shape, db_fps.shape[0]
    if db_fps.shape[1] != w:
        raise ValueError(
            f"word width mismatch: queries {w} vs database {db_fps.shape[1]}"
        )
    if w == 0:
        raise ValueError("fingerprints must have at least one word")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if n >= 2**31 - 1:
        raise ValueError(f"plane of {n} rows overflows the int32 row index")
    qc = row_counts(q_fps) if q_counts is None else q_counts
    dc = row_counts(db_fps) if db_counts is None else db_counts
    _check("q_counts", qc, torch.int32, 1, dev)
    _check("db_counts", dc, torch.int32, 1, dev)
    if qc.shape[0] != qn or dc.shape[0] != n:
        raise ValueError(
            f"counts of {qc.shape[0]} / {dc.shape[0]} rows for {qn} / {n}"
        )
    if qn == 0 or n == 0:
        return (
            torch.full((qn, k), PAD_SCORE, dtype=torch.float32, device=dev),
            torch.full((qn, k), PAD_INDEX, dtype=torch.int32, device=dev),
        )
    out_s = torch.empty((qn, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((qn, k), dtype=torch.int32, device=dev)
    p = plan(qn, n, w, k)
    scratch = torch.empty(p.scratch_bytes // 8, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            db_fps.data_ptr(), dc.data_ptr(), q_fps.data_ptr(), qc.data_ptr(),
            n, w, qn, k, 0 if p.route == "filter" else 1, p.qpb, p.slices,
            p.rows_per_slice, p.width, p.fresh, p.slots, p.query_chunk,
            scratch.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"tanimoto kernel launch failed ({p.route} route): cudaError {err}")
    count_launch(tanimoto_topk_cuda)
    return out_s, out_i


tanimoto_topk_cuda.launches = 0
