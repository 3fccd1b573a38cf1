"""CUDA wrapper for ``tanimoto`` (source: ``src/repro_torch/csrc/tanimoto.cu``).

Replaces the Pallas kernel ``tanimoto_blocks_pallas`` / ``_tanimoto_kernel``
of ``src/repro/kernels/tanimoto/kernel.py`` (wrapped there by
``tanimoto_topk_pallas``).  What bounds it on an H100: the operations —
``Q * N * W`` population counts, which the card retires at 16 per clock per
SM, take longer than reading the ``N * (4W + 4)`` bytes of the plane.
Design: stage 1 gives each warp a group of queries and a slice of rows and
keeps a sorted top-k per (query, slice) in shared memory; stage 2 merges
the slices' lists with one warp per query.  Every comparison is on
``(score, row)``, so the result is bit-exact with the plain version
whatever the slicing.  See the source for the details.

``k`` is at most :data:`MAX_K`; the wrapper raises above it (the
reference takes any k).  Rows are int32, so the plane has fewer than
``2**31`` rows.

``tanimoto_topk_cuda.launches`` counts the launches of the kernel
(thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..build import count_launch, load
from .ref import PAD_INDEX, PAD_SCORE, row_counts

__all__ = ["MAX_K", "plan", "tanimoto_topk_cuda"]

MAX_K = 1024
_WARPS = 4                  # kWarps: warps (slices) per stage-1 block
_QPW = (8, 4, 1)            # queries per warp the source is built for
_SMEM_LIMIT = 232_448       # dynamic shared memory a block may use (sm_90)
_TARGET_WARPS = 132 * 64    # stage-1 warps to aim for: 64 per SM of an H100
_MIN_SLICE_ROWS = 1024      # and at least max(this, 16 k) rows per slice
_MAX_SLICES = 12_288        # stage 2 keeps one int per slice in 48 KB
_SCRATCH_BYTES = 1 << 30    # stage-1 lists: (Q, slices, k) x 8 bytes

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("tanimoto").tanimoto_topk_launch
        f.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 5
        )
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(nq: int, n: int, w: int, k: int) -> Tuple[int, int, int]:
    """``(queries per warp, slices, rows per slice)`` for one launch.

    Queries per warp: the largest of 8, 4, 1 that the batch fills and
    whose stage-1 block fits in shared memory.  Slices: enough warps to
    fill the card, but each slice at least ``max(1024, 16 k)`` rows (a
    slice's list costs ``k`` inserts to fill) and the stage-1 lists at
    most 1 GiB; a multiple of 4 (one slice per warp of a block).
    """
    for qpw in _QPW:
        if (qpw <= nq or qpw == 1) and 4 * qpw * w + 8 * _WARPS * qpw * k <= _SMEM_LIMIT:
            break
    else:  # pragma: no cover - only at W of thousands of words
        raise ValueError(f"W={w}, k={k} do not fit the kernel's shared memory")
    groups = _cdiv(nq, qpw)
    slices = min(
        _cdiv(_TARGET_WARPS, groups),
        _cdiv(n, max(_MIN_SLICE_ROWS, 16 * k)),
        _SCRATCH_BYTES // (8 * nq * k),
        _MAX_SLICES,
    )
    slices = _cdiv(max(1, slices), _WARPS) * _WARPS
    return qpw, slices, _cdiv(n, slices)


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
    if not 1 <= k <= MAX_K:
        raise ValueError(
            f"k must be in [1, {MAX_K}] for the CUDA tanimoto kernel, got {k}"
        )
    if n >= 2**31:
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
    qpw, slices, rows_per_slice = plan(qn, n, w, k)
    ss = torch.empty((qn, slices, k), dtype=torch.float32, device=dev)
    si = torch.empty((qn, slices, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            db_fps.data_ptr(), dc.data_ptr(), q_fps.data_ptr(), qc.data_ptr(),
            n, w, qn, k, slices, rows_per_slice, qpw,
            ss.data_ptr(), si.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"tanimoto kernel launch failed: cudaError {err}")
    count_launch(tanimoto_topk_cuda)
    return out_s, out_i


tanimoto_topk_cuda.launches = 0
