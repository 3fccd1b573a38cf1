"""Public entry points for ``hash_mix``.

``hash_mix(x)`` launches the CUDA kernel on a CUDA tensor and runs the
plain PyTorch version on a CPU tensor.  There is no other route: a CUDA
tensor never falls back to the plain version.  ``hash_mix_u64`` and
``digest_ids`` are the reference's helpers on top of it: the first 64
digest bits of packed rows, and of a list of id strings.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import DeviceLike, resolve_device
from .kernel import hash_mix_cuda
from .ref import hash_mix_ref

__all__ = ["digest_ids", "hash_mix", "hash_mix_u64"]


def hash_mix(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``(N, W) uint32 → (N, 4) uint32`` digest (see kernel/ref)."""
    if x.device.type == "cuda":
        return hash_mix_cuda(x, seed=seed)
    if x.device.type == "cpu":
        return hash_mix_ref(x, seed=seed)
    raise ValueError(f"hash_mix: unsupported device {x.device}")


def hash_mix_u64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """First 64 digest bits as ``(N, 2) uint32`` (hi, lo) pairs, on ``x``'s
    device.

    The sorted-probe membership path keys on 64-bit digests; collisions at
    that width degrade to an extra full-id verify, never to wrong results.
    """
    return hash_mix(x, seed=seed)[:, :2]


def digest_ids(ids, seed: int = 0, device: DeviceLike = "cuda") -> np.ndarray:
    """Host convenience: list[str] → ``(N, 2)`` uint32 digests on the host,
    the ids packed on the host and mixed on ``device``."""
    from ...core.packing import pack_ids  # core imports this module

    dev = resolve_device(device)
    packed = torch.from_numpy(pack_ids(list(ids))).to(dev)
    # through int32 views: the card's torch does not index uint32
    out = hash_mix(packed, seed=seed).view(torch.int32)[:, :2]
    return out.cpu().numpy().view(np.uint32)
