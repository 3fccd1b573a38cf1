"""CUDA wrapper for ``ssd_scan`` (source: ``src/repro_torch/csrc/ssd_scan.cu``).

Replaces the Pallas kernel ``ssd_scan_pallas`` / ``_ssd_kernel`` of
``src/repro/kernels/ssd_scan/kernel.py``.  What bounds it on an H100: the
bytes — states read once, prefix written once, against one multiply and
one add per element.  Design: each thread owns 4 consecutive elements of
one (bh, P*N) state tile (float4 loads, coalesced along P*N) and loops
over the chunks in order with the carry in registers.  See the source for
the details.

Takes contiguous float32 ``states (BH, C, P, N)`` and ``decay (BH, C)``;
returns a new contiguous float32 prefix.  Bit-exact with the plain version
(the source says why).

``ssd_scan_cuda.launches`` counts the launches of the kernel (thread-safe).
"""

from __future__ import annotations

import ctypes

import torch

from ..build import count_launch, load
from .ref import check_shapes

__all__ = ["ssd_scan_cuda"]

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("ssd_scan").ssd_scan_launch
        f.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def ssd_scan_cuda(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``states (BH, C, P, N)``, ``decay (BH, C)`` float32 CUDA tensors →
    prefix ``(BH, C, P, N)`` float32."""
    dev = states.device
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got {dev}")
    bh, c, p, n = check_shapes(states, decay)
    if decay.device != dev:
        raise ValueError(f"decay is on {decay.device}, states on {dev}")
    if states.dtype != torch.float32 or decay.dtype != torch.float32:
        raise TypeError(
            f"ssd_scan takes float32 states and decay, got {states.dtype}, "
            f"{decay.dtype}"
        )
    if not (states.is_contiguous() and decay.is_contiguous()):
        raise ValueError("ssd_scan_cuda needs contiguous states and decay")
    if c >= 2**31:
        raise ValueError(f"C={c} above the kernel's int32 chunk index")
    prefix = torch.empty_like(states, memory_format=torch.contiguous_format)
    if prefix.numel() == 0:
        return prefix
    pn = p * n
    vec = 4 if pn % 4 == 0 and states.data_ptr() % 16 == 0 else 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(states.data_ptr(), decay.data_ptr(), prefix.data_ptr(),
                    bh, c, pn, vec, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err}")
    count_launch(ssd_scan_cuda)
    return prefix


ssd_scan_cuda.launches = 0
