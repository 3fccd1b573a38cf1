"""CUDA wrapper for ``flash_attention``'s backward (source:
``src/repro_torch/csrc/flash_attention_bwd.cu``).

Replaces the gradient that ``jax.grad`` takes of the reference's chunked
XLA attention path (``src/repro/kernels/flash_attention/ref.py``): the
reference's Pallas kernel (``kernel.py:97``) has no backward.  What bounds
it on an H100: the operations, five products of ``2 * D`` flops for each
visible (query, key) pair and query head (``kernels.work.
attention_bwd_work``), all bf16 ``wgmma`` with float32 accumulators.

:func:`backward_route` decides, before any launch and from dtypes, shapes,
strides and base pointers alone, which backward a forward's inputs get.
It follows the forward's route (:func:`~.kernel.route`): ``"tensor_core"``
inputs get this kernel (the forward then also wrote the rows'
log-sum-exp), the rest (float32 and float64, bf16 that TMA cannot read)
get ``"ops"``, :func:`~.grad.flash_attention_bwd`'s float32 PyTorch ops.
The CPU always runs the ops.

:func:`flash_attention_bwd_cuda` launches three kernels on the current
stream: ``D = rowsum(dO * O)`` (with ``lse * log2 e``, rows padded to
whole tiles), then dK and dV (one block per KV head and
64 keys, summing the group's query heads in registers), then dQ (one block
per query head and 128 queries).  No atomics: two launches give the same
bits.  ``d_out`` is read through its strides; one that TMA cannot read is
first copied to a contiguous tensor (autograd hands the model's transposed
view, which TMA reads).  A launch that fails raises; nothing falls back.

``flash_attention_bwd_cuda.launches`` counts backwards (one each, whatever
number of kernels it launches), ``window_launches`` those with a sliding
window that masks (``window < Skv``); ``delta_launches``, ``dkdv_launches``
and ``dq_launches`` count each kernel's launches (thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import count_launch, load
from .kernel import map_dims, route, tma_readable
from .ref import check_shapes

__all__ = ["backward_route", "flash_attention_bwd_cuda"]

DQ_ROWS = 128      # query rows a block of the dQ pass
# the kernels in launch order, each with its counter
_KERNELS = ((0, "delta_launches"), (1, "dkdv_launches"), (2, "dq_launches"))

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("flash_attention_bwd").flash_attention_bwd_launch
        f.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 11
            + [ctypes.POINTER(ctypes.c_uint64)] * 2 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p]
        )
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def backward_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``"tensor_core"`` (this kernel) or ``"ops"`` (the float32 PyTorch
    ops): the forward's route decides."""
    return "tensor_core" if route(q, k, v) == "tensor_core" else "ops"


def flash_attention_bwd_cuda(q, k, v, out, d_out, lse, causal: bool = True,
                             window: Optional[int] = None,
                             scale: Optional[float] = None):
    """``(dq, dk, dv)``, bf16 and contiguous, of ``flash_attention(q, k, v,
    causal, window, scale)`` on the tensor-core route, whose output was
    ``out`` (contiguous ``(B, Hq, Sq, D)``) and row log-sum-exp ``lse``
    (float32 ``(B, Hq, Sq)``), for the output gradient ``d_out``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_bwd_cuda needs CUDA tensors, got {dev}")
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    if backward_route(q, k, v) != "tensor_core":
        raise ValueError("flash_attention_bwd_cuda takes the tensor-core route's inputs "
                         "only (bf16 views that TMA reads)")
    for name, t, dtype, shape in (("out", out, torch.bfloat16, (b, hq, sq, d)),
                                  ("d_out", d_out, torch.bfloat16, (b, hq, sq, d)),
                                  ("lse", lse, torch.float32, (b, hq, sq))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if not (out.is_contiguous() and lse.is_contiguous()):
        raise ValueError("out and lse must be contiguous (as the forward writes them)")
    if -(-sq // DQ_ROWS) > 65_535 or b * hkv > 65_535:
        raise ValueError(f"Sq={sq} or B x Hkv={b * hkv} above the kernels' grid")
    if not tma_readable(d_out):
        d_out = d_out.contiguous()
    dq = torch.empty((b, hq, sq, d), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, hkv, skv, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or dk.numel() == 0:  # no key, or no query: zero gradients
        return dq.zero_(), dk.zero_(), dv.zero_()
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    # as the forward: a window as wide as the key stream masks nothing
    has_window = window is not None and window < skv
    win = max(int(window), -(2**30)) if has_window else 0
    # the rows' lse * log2 e and D = rowsum(dO * O), rows padded to whole
    # 128-row tiles (the first kernel writes both)
    sq_pad = -(-sq // DQ_ROWS) * DQ_ROWS
    lse2 = torch.empty((b, hq, sq_pad), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse2)
    maps = [map_dims(t) for t in (q, k, v, d_out)]
    dims = (ctypes.c_uint64 * 16)(*(x for m in maps for x in m["dims"]))
    strides = (ctypes.c_uint64 * 12)(*(x for m in maps for x in m["strides"]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for kernel, counter in _KERNELS:
            err = _fn()(
                kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                d_out.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dims, strides, b, hq, hkv, sq, skv, d,
                int(causal), int(has_window), win, float(scale), stream,
            )
            if err == -1:
                raise RuntimeError("flash_attention backward: the CUDA driver has no "
                                   "cuTensorMapEncodeTiled")
            if err <= -1000:
                raise RuntimeError(f"flash_attention backward: a tensor map was refused "
                                   f"(CUresult {-1000 - err}): {maps}")
            if err != 0:
                raise RuntimeError(f"flash_attention backward kernel {kernel} launch "
                                   f"failed: cudaError {err}")
            count_launch(flash_attention_bwd_cuda, counter)
    count_launch(flash_attention_bwd_cuda,
                 *(("launches", "window_launches") if has_window else ()))
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.window_launches = 0
flash_attention_bwd_cuda.delta_launches = 0
flash_attention_bwd_cuda.dkdv_launches = 0
flash_attention_bwd_cuda.dq_launches = 0
