"""CUDA wrapper for ``sorted_probe`` (source:
``src/repro_torch/csrc/sorted_probe.cu``).

Replaces the Pallas kernel ``probe_blocks_pallas`` / ``_probe_kernel`` of
``src/repro/kernels/sorted_probe/kernel.py`` and its stages A and C
(``sorted_probe_pallas`` and ``_fence_assign`` in ``ops.py``).  Design:
one thread per query, a branch-free lower-bound search over the whole
table returning the global lower bound, so the TPU design's fence
bucketing, dense block compare and overflow fallback are gone.

What bounds it on an H100: the rate at which the memory system serves
scattered requests (a warp's search step is 32 loads at unrelated
addresses), not the bytes.  A persistent grid that ran the search's top
levels from shared memory was measured against this kernel on the card
and paid only for a few hundred thousand queries in one table, a shape
the funnel's per-shard probes and the service's requests never send; it
was not kept (``PERF.md``).  At a serving request's shape the call's cost
is the host's: an H100 runs the search in about 5 us.

``sorted_probe_cuda.launches`` counts the launches of the kernel (thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..build import count_launch, load

__all__ = ["sorted_probe_cuda"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("sorted_probe").sorted_probe_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def _check_pairs(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.uint32 or t.ndim != 2 or t.shape[1] != 2:
        raise TypeError(
            f"{name} must be (N, 2) uint32, got {tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sorted_probe_cuda(
    queries: torch.Tensor, table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(found (Q,) bool, pos (Q,) int32)`` of ``queries`` in sorted ``table``."""
    if queries.device.type != "cuda" or table.device != queries.device:
        raise ValueError(
            "sorted_probe_cuda needs queries and table on one CUDA device, "
            f"got {queries.device} and {table.device}"
        )
    _check_pairs("queries", queries)
    _check_pairs("table", table)
    q = queries.shape[0]
    m = table.shape[0]
    if m >= 2**31:
        raise ValueError(f"table of {m} rows overflows the int32 positions")
    found = torch.empty(q, dtype=torch.bool, device=queries.device)
    pos = torch.empty(q, dtype=torch.int32, device=queries.device)
    if q == 0:
        return found, pos
    if m == 0:
        return found.zero_(), pos.zero_()
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(queries.data_ptr(), table.data_ptr(), found.data_ptr(),
                    pos.data_ptr(), q, m, stream)
    if err != 0:
        raise RuntimeError(f"sorted_probe kernel launch failed: cudaError {err}")
    count_launch(sorted_probe_cuda)
    return found, pos


sorted_probe_cuda.launches = 0
