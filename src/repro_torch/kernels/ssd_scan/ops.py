"""Public entry point for ``ssd_scan``, with its gradient.

``ssd_scan(states, decay)`` — the prefix states of the Mamba2 inter-chunk
recurrence (see ref.py).  A CUDA tensor launches the CUDA kernel; a CPU
tensor runs the plain PyTorch version.  A CUDA tensor never falls back to
the plain version; a ``meta`` tensor (the dry-run) gives an empty output
and counts the kernel's work; a DTensor raises.

Gradients flow through :class:`SSDScan`, a ``torch.autograd.Function``.
With ``prefix[c] = h[c]``, ``h[0] = 0`` and ``h[c+1] = decay[c] h[c] +
states[c]``, the adjoint of ``g = dL/dprefix`` is the same recurrence run
backwards: ``a[c] = g[c] + decay[c] a[c+1]``, ``a[C] = 0``, and

    dL/dstates[c] = a[c+1] = flip(ssd_scan(flip(g), flip(decay)))[c]
    dL/ddecay[c]  = sum_{p,n} dL/dstates[c] * prefix[c]

(flips along the chunk axis; the last chunk's state gradient is 0, as
``h[C]`` is no output).  So the backward pass is one more launch of the
same scan — the CUDA kernel on the card, the plain version on the CPU —
on flipped contiguous copies, plus one reduction in PyTorch (the
reference takes that sum outside any kernel too).  The kernel multiplies
then adds, as autograd through the plain version does, so the state
gradient equals autograd's through ``ssd_scan_ref`` bit for bit.
"""

from __future__ import annotations

import torch

from .. import work
from ..flash_attention.ops import reject_dtensors
from .kernel import ssd_scan_cuda
from .ref import ssd_scan_ref

__all__ = ["SSDScan", "ssd_scan"]


def _scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    if states.device.type == "cuda":
        return ssd_scan_cuda(states, decay)
    if states.device.type == "cpu" and decay.device.type == "cpu":
        return ssd_scan_ref(states, decay)
    if states.device.type == "meta" and decay.device.type == "meta":
        # the dry-run: shapes only, and the kernel's work on its counter
        work.record("ssd_scan", *work.scan_work(*states.shape))
        return torch.empty_like(states)
    raise ValueError(
        f"ssd_scan: unsupported devices {states.device} / {decay.device}"
    )


class SSDScan(torch.autograd.Function):
    """The scan forward, its adjoint scan backward (see the module)."""

    @staticmethod
    def forward(ctx, states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
        prefix = _scan(states, decay)
        ctx.save_for_backward(decay, prefix)
        return prefix

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        decay, prefix = ctx.saved_tensors
        d_states = _scan(g.flip(1).contiguous(), decay.flip(1).contiguous()).flip(1)
        d_decay = None
        if ctx.needs_input_grad[1]:
            d_decay = (d_states * prefix).sum(dim=(2, 3))
        return d_states, d_decay


def ssd_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """``(BH, C, P, N)`` prefix states, differentiable; see kernel/ref."""
    reject_dtensors("ssd_scan", states, decay)
    return SSDScan.apply(states, decay)
