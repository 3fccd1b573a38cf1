"""CUDA wrapper for ``hash_mix`` (source: ``src/repro_torch/csrc/hash_mix.cu``).

Replaces the Pallas kernel ``hash_mix_pallas`` / ``_hash_mix_kernel`` of
``src/repro/kernels/hash_mix/kernel.py``.  What bounds it on an H100: the
bytes — ``N * (4W + 16)`` moved against ~20 integer operations per 4-byte
lane.  Design: one thread per row walking its W lanes in registers; the
loads are strided per warp (a later change can stage rows through shared
memory to coalesce them).  See the source for the details.

``hash_mix_cuda.launches`` counts the launches of the kernel (thread-safe).
"""

from __future__ import annotations

import ctypes

import torch

from ..build import count_launch, load

__all__ = ["hash_mix_cuda"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("hash_mix").hash_mix_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def hash_mix_cuda(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``(N, W)`` uint32 CUDA tensor → ``(N, 4)`` uint32 digests."""
    if x.device.type != "cuda":
        raise ValueError(f"hash_mix_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.uint32 or x.ndim != 2:
        raise TypeError(
            f"hash_mix expects (N, W) uint32, got {tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("hash_mix_cuda needs a contiguous (N, W) tensor")
    n, w = x.shape
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    out = torch.empty((n, 4), dtype=torch.uint32, device=x.device)
    if n == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x.data_ptr(), out.data_ptr(), n, w, seed, stream)
    if err != 0:
        raise RuntimeError(f"hash_mix kernel launch failed: cudaError {err}")
    count_launch(hash_mix_cuda)
    return out


hash_mix_cuda.launches = 0
