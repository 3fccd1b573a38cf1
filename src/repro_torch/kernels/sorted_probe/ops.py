"""Public entry point for ``sorted_probe``.

``sorted_probe(queries, table)`` — membership and global lower bound of
``(Q, 2)`` uint32 keys in a sorted ``(M, 2)`` uint32 table (duplicates
allowed).  A CUDA tensor launches the CUDA kernel; a CPU tensor runs the
plain PyTorch version.  A CUDA tensor never falls back to the plain
version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernel import sorted_probe_cuda
from .ref import sorted_probe_ref

__all__ = ["sorted_probe"]


def sorted_probe(
    queries: torch.Tensor, table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(found (Q,) bool, pos (Q,) int32)``; see kernel/ref."""
    if queries.device.type == "cuda":
        return sorted_probe_cuda(queries, table)
    if queries.device.type == "cpu" and table.device.type == "cpu":
        return sorted_probe_ref(queries, table)
    raise ValueError(
        f"sorted_probe: unsupported devices {queries.device} / {table.device}"
    )
