"""String-id ↔ fixed-width tensor packing (device adaptation layer).

Accelerators stream dense arrays, not heaps of Python strings.  This
module packs variable-length identifier strings into ``(N, W)`` uint32
lane tensors (zero-padded, 4 chars per lane) — the representation
consumed by the ``hash_mix`` CUDA kernel.

Width is chosen per corpus (max id length rounded up to a multiple of 8
lanes = 32 bytes), the reference package's layout.  Packing is injective for
ids ≤ W*4 bytes: unpack(pack(x)) == x.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["pack_ids", "unpack_ids", "lanes_for"]


def lanes_for(ids: Sequence[str], min_lanes: int = 8) -> int:
    """Number of uint32 lanes needed for the longest id (multiple of 8)."""
    max_len = max((len(s.encode()) for s in ids), default=1)
    lanes = (max_len + 3) // 4
    return max(min_lanes, ((lanes + 7) // 8) * 8)


def pack_ids(ids: Sequence[str], lanes: int | None = None) -> np.ndarray:
    """Pack utf-8 id strings into a ``(N, lanes)`` uint32 array.

    Little-endian within each lane; zero padding after the id bytes.  Raises
    if any id exceeds the lane budget (silent truncation would reintroduce
    exactly the aliasing bug the paper warns about).
    """
    if lanes is None:
        lanes = lanes_for(ids)
    width = lanes * 4
    n = len(ids)
    buf = np.zeros((n, width), dtype=np.uint8)
    for i, s in enumerate(ids):
        b = s.encode()
        if len(b) > width:
            raise ValueError(
                f"id of {len(b)} bytes exceeds packing width {width}; "
                "increase lanes (never truncate identifiers)"
            )
        buf[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return buf.reshape(n, lanes, 4).view(np.uint32).reshape(n, lanes)


def unpack_ids(packed: np.ndarray) -> List[str]:
    """Inverse of :func:`pack_ids`."""
    n, lanes = packed.shape
    raw = packed.reshape(n, lanes, 1).view(np.uint8).reshape(n, lanes * 4)
    out: List[str] = []
    for i in range(n):
        row = raw[i]
        nz = np.nonzero(row)[0]
        end = (nz[-1] + 1) if len(nz) else 0
        out.append(bytes(row[:end]).decode("utf-8"))
    return out
