"""The port's device policy.

Entry points take an explicit ``device`` and default to ``"cuda"``: the
port runs on the card unless the caller asks for the host.  Asking for the
card where there is none raises; nothing falls back to the CPU quietly.

:func:`construct_on_meta` is for the two callers that build a model's
shapes without its memory, the dry-run (``launch/dryrun.py``) and the
spec comparison of full configs: inside it, every tensor factory call
that names a device builds on ``meta``, so ``init`` functions called with
``device="cpu"`` allocate nothing.  The entry points' policy is the same
inside it: ``meta`` is never a device they accept.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch
from torch.overrides import TorchFunctionMode

__all__ = ["construct_on_meta", "resolve_device"]

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


class _OnMeta(TorchFunctionMode):
    """Rewrites the ``device`` argument of every torch call to ``meta``."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


@contextlib.contextmanager
def construct_on_meta() -> Iterator[None]:
    """Build on ``meta`` whatever the block's tensor factories name as their
    device (see the module docstring)."""
    with _OnMeta():
        yield
