"""Plain PyTorch version of the ``ssd_scan`` kernel: the Mamba2 SSD
inter-chunk state recurrence.

The SSD chunked form splits a sequence into chunks; the terms inside a
chunk are dense products (left to ``torch.einsum``/``torch.matmul``), and
across chunks a compact per-(batch x head) state follows

    h[0]     = 0
    h[c + 1] = decay[c] * h[c] + states[c]

over ``states (BH, C, P, N)`` float32 and the scalar chunk decays ``decay
(BH, C)`` float32.  The output is the *prefix* state entering each chunk,
``prefix[:, c] = h[c]``, in states' dtype and shape.  The carry is float32,
and each step is a multiply then an add (no fused multiply-add), as the
CUDA kernel does it.  Runs on any device; the CPU tests and the CPU model
path use it, and on the card it is the yardstick the kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["check_shapes", "ssd_scan_ref"]


def check_shapes(states: torch.Tensor, decay: torch.Tensor):
    """``(BH, C, P, N)`` of a valid call; raises otherwise."""
    if states.ndim != 4 or decay.ndim != 2:
        raise ValueError(f"bad shapes {tuple(states.shape)} {tuple(decay.shape)}")
    bh, c, p, n = states.shape
    if tuple(decay.shape) != (bh, c):
        raise ValueError(f"decay {tuple(decay.shape)} != {(bh, c)}")
    return bh, c, p, n


def ssd_scan_ref(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``states (BH, C, P, N), decay (BH, C) → prefix (BH, C, P, N)``."""
    bh, c, p, n = check_shapes(states, decay)
    prefix = torch.empty_like(states)
    h = torch.zeros((bh, p, n), dtype=torch.float32, device=states.device)
    for j in range(c):
        prefix[:, j] = h
        h = decay[:, j, None, None].float() * h + states[:, j].float()
    return prefix
