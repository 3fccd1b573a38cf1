"""CUDA wrapper for ``flash_attention`` (source:
``src/repro_torch/csrc/flash_attention.cu``).

Replaces the Pallas kernel ``flash_attention_pallas`` / ``_fa_kernel`` of
``src/repro/kernels/flash_attention/kernel.py``.  What bounds it on an
H100: the operations — two products of ``2 * B * Hq * Sq * Skv * D`` flops
(halved by a causal mask) against one read of q, k, v and one write of
the output.

Two kernels, and :func:`route` picks one before launch from the inputs
alone (never after a failure):

* ``"tensor_core"``: bfloat16 with ``D`` a multiple of 8 up to 256, base
  pointers 16-byte aligned and the batch, head and sequence strides
  positive multiples of 16 bytes (what TMA reads).  Q, K and V tiles reach
  shared memory by TMA through 4-D tensor maps ``{D, S, H, B}`` over the
  strided views (:func:`tensor_maps` gives their dims, byte strides and
  boxes), and both products run on the tensor cores (``wgmma``), P
  rounded to bf16 for the second.
* ``"cuda_core"``: everything else (float32, or bf16 that TMA cannot
  read): one 128-thread block per (batch x query head, query tile),
  float32 tiles in shared memory, products on the float32 CUDA cores.

A tensor-core launch that fails raises; nothing falls back.  With
``return_lse`` the tensor-core kernel also writes each row's log-sum-exp
(float32 ``(B, Hq, Sq)``, natural log of ``sum_j exp(scale q.k_j)`` over
the visible keys, ``+inf`` for a row that sees none) for the backward
kernel (``backward.py``); the output's bits are the same with or without
it, and serving never asks for it.

Strides: both kernels read q, k and v through their batch, head and
sequence strides, so the ``(B, S, H, D) → (B, H, S, D)`` views of the
model pass without a copy; the head dim must be unit-stride (the wrapper
raises otherwise).  The output is a new contiguous ``(B, Hq, Sq, D)``
tensor.  Any ``Sq`` and ``Skv`` are taken (the kernels mask ragged tile
edges), and ``D`` up to 256.

``flash_attention_cuda.launches`` counts the launches of either kernel,
``flash_attention_cuda.tc_launches`` those of the tensor-core one
(thread-safe).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from ..build import count_launch, load
from .ref import check_shapes

__all__ = ["MAX_D", "flash_attention_cuda", "map_dims", "route", "tc_tiles",
           "tensor_maps", "tma_readable"]

MAX_D = 256
TC_BQ = 128        # query rows a tensor-core block takes
TMA_ALIGN = 16     # bytes: TMA's alignment of base pointers and strides
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_FN = None
_TC_FN = None


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


def _tc_fn():
    global _TC_FN
    if _TC_FN is None:
        f = load("flash_attention").flash_attention_tc_launch
        f.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.POINTER(ctypes.c_uint64)] * 2 + [ctypes.POINTER(ctypes.c_uint32)]
            + [ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
        )
        f.restype = ctypes.c_int
        _TC_FN = f
    return _TC_FN


def tc_tiles(d: int) -> Tuple[int, int]:
    """``(DP, BK)`` of the tensor-core kernel for head dim ``d``: D padded
    to 64, 128 or 256 (one 128-byte swizzle atom per 64 bf16 columns) and
    the keys a tile (64 at D = 256, so that Q and two stages of K and V fit
    in 192 KB of shared memory)."""
    if d <= 64:
        return 64, 128
    if d <= 128:
        return 128, 128
    return 256, 64


def tma_readable(t: torch.Tensor) -> bool:
    """A 4-D bf16 tensor that a ``{D, S, H, B}`` tensor map can read: base
    16-byte aligned, unit-stride head dim, the other strides positive
    multiples of 16 bytes."""
    if t.dtype != torch.bfloat16 or t.ndim != 4 or t.data_ptr() % TMA_ALIGN:
        return False
    if t.shape[3] > 1 and t.stride(3) != 1:
        return False
    return all(t.stride(dim) * t.element_size() > 0
               and t.stride(dim) * t.element_size() % TMA_ALIGN == 0 for dim in range(3))


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tensor_core"`` or ``"cuda_core"``: which kernel takes these
    inputs.  Decided from dtypes, shapes, strides and base pointers only."""
    d = q.shape[-1]
    if d == 0 or d % 8 or d > MAX_D:
        return "cuda_core"
    return "tensor_core" if all(tma_readable(t) for t in (q, k, v)) else "cuda_core"


def tensor_maps(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> Dict[str, tuple]:
    """What the wrapper hands to ``cuTensorMapEncodeTiled`` for each of q, k
    and v (tensor-core route): ``dims`` ``(D, S, H, B)`` in elements,
    ``strides`` the byte strides of S, H and B, ``box`` ``(64, rows, 1,
    1)`` with ``rows`` = 128 query rows or ``BK`` keys."""
    _, bk = tc_tiles(q.shape[3])
    return {name: dict(map_dims(t), box=(64, rows, 1, 1))
            for name, t, rows in (("q", q, TC_BQ), ("k", k, bk), ("v", v, bk))}


def map_dims(t: torch.Tensor) -> Dict[str, tuple]:
    """``dims`` ``(D, S, H, B)`` in elements and ``strides`` the byte
    strides of S, H and B: a 4-D tensor map over ``t``'s strided view."""
    size = t.element_size()
    return dict(dims=(t.shape[3], t.shape[2], t.shape[1], t.shape[0]),
                strides=(t.stride(2) * size, t.stride(1) * size, t.stride(0) * size))


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """``q (B, Hq, Sq, D)``, ``k, v (B, Hkv, Skv, D)`` on one CUDA device,
    float32 or bfloat16 → ``(B, Hq, Sq, D)`` in q's dtype; with
    ``return_lse`` (tensor-core route only) ``(out, lse)``."""
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
    tc = route(q, k, v) == "tensor_core"
    if return_lse and not tc:
        raise ValueError("flash_attention_cuda: only the tensor-core route writes "
                         "the log-sum-exp")
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=dev)
    # the kernel writes every row's log-sum-exp
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev) if return_lse else None
    if out.numel() == 0 or skv == 0:  # skv == 0: no key is visible to any row
        out.zero_()
        if return_lse:
            return out, lse.fill_(math.inf)
        return out
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # a window as wide as the key stream masks nothing; one far below it
    # masks everything, as -2**30 does (the kernel's window is an int32)
    has_window = window is not None and window < skv
    win = max(int(window), -(2**30)) if has_window else 0
    if tc:
        _launch_tc(q, k, v, out, lse, b, hq, hkv, sq, skv, d, causal, has_window,
                   win, float(scale))
        count_launch(flash_attention_cuda, "tc_launches")
    else:
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
            raise RuntimeError(
                f"flash_attention kernel launch failed: cudaError {err}")
    count_launch(flash_attention_cuda)
    return (out, lse) if return_lse else out


def _launch_tc(q, k, v, out, lse, b, hq, hkv, sq, skv, d, causal, has_window, win,
               scale) -> None:
    maps = tensor_maps(q, k, v)
    dp, bk = tc_tiles(d)
    dims = (ctypes.c_uint64 * 12)(*(x for n in "qkv" for x in maps[n]["dims"]))
    strides = (ctypes.c_uint64 * 9)(*(x for n in "qkv" for x in maps[n]["strides"]))
    boxes = (ctypes.c_uint32 * 12)(*(x for n in "qkv" for x in maps[n]["box"]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _tc_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            dims, strides, boxes, b, hq, hkv, sq, skv, d, dp, bk,
            int(causal), int(has_window), win, scale, stream,
        )
    if err == -1:
        raise RuntimeError("flash_attention tensor-core route: the CUDA driver "
                           "has no cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"flash_attention tensor-core route: a tensor map was "
                           f"refused (CUresult {-1000 - err}): {maps}")
    if err != 0:
        raise RuntimeError(
            f"flash_attention tensor-core launch failed: cudaError {err}")


flash_attention_cuda.launches = 0
flash_attention_cuda.tc_launches = 0
