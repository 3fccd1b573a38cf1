"""The port's device policy.

Entry points take an explicit ``device`` and default to ``"cuda"``: the
port runs on the card unless the caller asks for the host.  Asking for the
card where there is none raises; nothing falls back to the CPU quietly.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a :class:`torch.device`, checked to exist here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but CUDA is not "
                "available (torch.cuda.is_available() is False); pass "
                "device='cpu' to run on the host"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    return dev
