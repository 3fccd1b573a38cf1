"""Plain PyTorch version of ``sorted_probe``: membership of 64-bit keys in a
sorted table.

Keys are ``(hi, lo)`` uint32 pairs.  This is a transliteration of the
reference package's ``sorted_probe_ref``: the same fixed-step branch-free
binary search over the whole table (``M.bit_length()`` rounds of midpoint
gathers, with ``active`` making the converged state a fixed point).  It
returns, per query,

* ``found`` — whether the key is present,
* ``pos``   — the global lower bound (first index with ``table[idx] >=
  query``; the head of the run when the table holds duplicates).

PyTorch has no unsigned comparisons on the CPU, so each pair becomes the
int64 key ``(hi << 32 | lo) ^ (1 << 63)``: flipping the sign bit makes
signed order equal unsigned order.  Runs on any device; the CPU tests use
it, and on the card it is the yardstick the CUDA kernel is held to.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..hash_mix.ref import from_u32

__all__ = ["pairs_to_key", "sorted_probe_ref"]

_SIGN = -(2**63)  # int64 with only the sign bit set


def pairs_to_key(pairs: torch.Tensor) -> torch.Tensor:
    """``(N, 2)`` uint32 ``(hi, lo)`` → int64 keys in unsigned order."""
    v = from_u32(pairs)
    return ((v[:, 0] << 32) | v[:, 1]) ^ _SIGN


def sorted_probe_ref(
    queries: torch.Tensor, table: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``queries (Q,2) uint32`` against ``table (M,2) uint32`` (sorted asc).

    Returns ``(found (Q,) bool, pos (Q,) int32)``.
    """
    if queries.ndim != 2 or queries.shape[1] != 2:
        raise ValueError(f"queries must be (Q, 2), got {tuple(queries.shape)}")
    if table.ndim != 2 or table.shape[1] != 2:
        raise ValueError(f"table must be (M, 2), got {tuple(table.shape)}")
    dev = queries.device
    q = queries.shape[0]
    m = table.shape[0]
    if m == 0:
        return (torch.zeros(q, dtype=torch.bool, device=dev),
                torch.zeros(q, dtype=torch.int32, device=dev))
    qk = pairs_to_key(queries)
    tk = pairs_to_key(table)

    lo_b = torch.zeros(q, dtype=torch.int64, device=dev)
    hi_b = torch.full((q,), m, dtype=torch.int64, device=dev)
    for _ in range(max(1, m.bit_length())):
        active = lo_b < hi_b
        mid = (lo_b + hi_b) // 2
        go_right = tk[mid.clamp(max=m - 1)] < qk  # table[mid] < query
        lo_b = torch.where(active & go_right, mid + 1, lo_b)
        hi_b = torch.where(active & ~go_right, mid, hi_b)
    pos = lo_b
    found = (pos < m) & (tk[pos.clamp(max=m - 1)] == qk)
    return found, pos.to(torch.int32)
