"""Public entry point for ``hash_mix``.

``hash_mix(x)`` launches the CUDA kernel on a CUDA tensor and runs the
plain PyTorch version on a CPU tensor.  There is no other route: a CUDA
tensor never falls back to the plain version.
"""

from __future__ import annotations

import torch

from .kernel import hash_mix_cuda
from .ref import hash_mix_ref

__all__ = ["hash_mix"]


def hash_mix(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``(N, W) uint32 → (N, 4) uint32`` digest (see kernel/ref)."""
    if x.device.type == "cuda":
        return hash_mix_cuda(x, seed=seed)
    if x.device.type == "cpu":
        return hash_mix_ref(x, seed=seed)
    raise ValueError(f"hash_mix: unsupported device {x.device}")
