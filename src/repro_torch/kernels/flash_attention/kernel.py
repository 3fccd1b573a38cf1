"""CUDA wrapper for ``flash_attention`` (source:
``src/repro_torch/csrc/flash_attention.cu``).

Replaces the Pallas kernel ``flash_attention_pallas`` / ``_fa_kernel`` of
``src/repro/kernels/flash_attention/kernel.py``.  What bounds it on an
H100: the operations — two products of ``2 * B * Hq * Sq * Skv * D`` flops
(halved by a causal mask) against one read of q, k, v and one write of
the output.  Design: a block of 128 threads per (batch x query head, tile
of queries) loops over the key tiles that hold a visible key, keeps K and
V tiles in shared memory as float32 and the softmax state and output tile
in registers, and does its arithmetic on the float32 CUDA cores (the
tensor cores are later work).  See the source for the details.

Strides: the kernel reads q, k and v through their batch, head and
sequence strides, so the ``(B, S, H, D) → (B, H, S, D)`` views of the
model pass without a copy; the head dim must be unit-stride (the wrapper
raises otherwise).  The output is a new contiguous ``(B, Hq, Sq, D)``
tensor.  Any ``Sq`` and ``Skv`` are taken (the kernel masks ragged tile
edges), and ``D`` up to 256.

``flash_attention_cuda.launches`` counts the launches of the kernel
(thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import count_launch, load
from .ref import check_shapes

__all__ = ["MAX_D", "flash_attention_cuda"]

MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("flash_attention").flash_attention_launch
        f.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 9 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_void_p]
        )
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv, D)`` on one CUDA device,
    float32 or bfloat16 → ``(B, Hq, Sq, D)`` in q's dtype."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(
                f"q, k, v must share one dtype of float32 / bfloat16, got "
                f"{q.dtype}, {k.dtype}, {v.dtype}"
            )
        if t.shape[3] > 1 and t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be unit-stride")
    if d > MAX_D:
        raise ValueError(f"head dim {d} above the kernel's {MAX_D}")
    if -(-sq // 32) > 65_535:
        raise ValueError(f"Sq={sq} above the kernel's grid")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if skv == 0:  # no key is visible to any row
        return out.zero_()
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # a window as wide as the key stream masks nothing; one far below it
    # masks everything, as -2**30 does (the kernel's window is an int32)
    has_window = window is not None and window < skv
    win = max(int(window), -(2**30)) if has_window else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, skv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(has_window), win, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    count_launch(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0
