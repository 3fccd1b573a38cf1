"""Public entry point for ``sorted_probe``.

``sorted_probe(queries, table)`` — membership and global lower bound of
``(Q, 2)`` uint32 keys in a sorted ``(M, 2)`` uint32 table (duplicates
allowed).  ``table`` is a plain tensor or a :class:`ProbeTable` (the table
with its fences, built once).  A CUDA tensor launches the CUDA kernel on
the table's route; a CPU tensor runs the plain PyTorch version, which
ignores the fences.  A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from .kernel import ProbeTable, sorted_probe_cuda
from .ref import sorted_probe_ref

__all__ = ["ProbeTable", "sorted_probe"]


def sorted_probe(
    queries: torch.Tensor, table: Union[torch.Tensor, ProbeTable]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(found (Q,) bool, pos (Q,) int32)``; see kernel/ref."""
    if queries.device.type == "cuda":
        return sorted_probe_cuda(queries, table)
    plain = table.table if isinstance(table, ProbeTable) else table
    if queries.device.type == "cpu" and plain.device.type == "cpu":
        return sorted_probe_ref(queries, plain)
    raise ValueError(
        f"sorted_probe: unsupported devices {queries.device} / {plain.device}"
    )
