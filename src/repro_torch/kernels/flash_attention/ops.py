"""Public entry point for ``flash_attention``, with its gradient.

``flash_attention(q, k, v, causal=True, window=None, scale=None)`` —
attention of ``q (B, Hq, Sq, D)`` against ``k, v (B, Hkv, Skv, D)``, the
queries being the last ``Sq`` positions of the key stream.  A CUDA tensor
launches the CUDA kernel; a CPU tensor runs the plain PyTorch version.  A
CUDA tensor never falls back to the plain version; a ``meta`` tensor (the
dry-run) gives an empty output and counts the kernel's work; a DTensor
raises.  Gradients flow through
:class:`~.grad.FlashAttention`: on the card the forward and, after a
tensor-core forward, the backward are kernels; elsewhere the backward is
PyTorch ops (see grad.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from .grad import FlashAttention

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``(B, Hq, Sq, D)`` in q's dtype, differentiable; see kernel/ref/grad."""
    reject_dtensors("flash_attention", q, k, v)
    training = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, causal, window, scale, training)


def reject_dtensors(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise if a DTensor reaches a kernel: its wrapper reads ``data_ptr()``
    and the device type, so a mesh path hands it local shards
    (``local_map``, see ``models/common.py``)."""
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{kernel}: a DTensor reached the kernel; under a mesh it takes "
            "each rank's local shard (local_map)")
