"""Public entry point for ``flash_attention``.

``flash_attention(q, k, v, causal=True, window=None, scale=None)`` —
attention of ``q (B, Hq, Sq, D)`` against ``k, v (B, Hkv, Skv, D)``, the
queries being the last ``Sq`` positions of the key stream.  A CUDA tensor
launches the CUDA kernel; a CPU tensor runs the plain PyTorch version.  A
CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_cuda
from .ref import flash_attention_ref

__all__ = ["flash_attention"]


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``(B, Hq, Sq, D)`` in q's dtype; see kernel/ref."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal, window, scale)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_ref(q, k, v, causal, window, scale)
    raise ValueError(
        f"flash_attention: unsupported devices {q.device} / {k.device} / "
        f"{v.device}"
    )
