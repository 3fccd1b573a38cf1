"""Public entry point for ``ssd_scan``.

``ssd_scan(states, decay)`` — the prefix states of the Mamba2 inter-chunk
recurrence (see ref.py).  A CUDA tensor launches the CUDA kernel; a CPU
tensor runs the plain PyTorch version.  A CUDA tensor never falls back to
the plain version.
"""

from __future__ import annotations

import torch

from .kernel import ssd_scan_cuda
from .ref import ssd_scan_ref

__all__ = ["ssd_scan"]


def ssd_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``(BH, C, P, N)`` prefix states; see kernel/ref."""
    if states.device.type == "cuda":
        return ssd_scan_cuda(states, decay)
    if states.device.type == "cpu" and decay.device.type == "cpu":
        return ssd_scan_ref(states, decay)
    raise ValueError(
        f"ssd_scan: unsupported devices {states.device} / {decay.device}"
    )
