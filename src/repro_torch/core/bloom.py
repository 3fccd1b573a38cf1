"""Bloom-filter sidecars: cheap membership prefilter for index shards.

A shard's Bloom filter answers "could this digest be in the shard?" from a
few cache-line-sized bit probes — misses (the overwhelmingly common case in
a sharded deployment where most keys route elsewhere or don't exist) are
rejected without touching the shard's mmap'd columns at all.  False
positives cost one wasted sorted-digest probe, never a wrong answer: the
digest search and the full-key verify behind it stay authoritative
(Algorithm 3 discipline).  This is the standard cheap-prefilter for
membership-heavy chemical workloads (Medina & White 2023).

Everything is vectorized numpy over ``uint64`` digest arrays so the filter
slots directly into the batched ``IndexStore.lookup_batch`` path.  Probe
positions come from double hashing (Kirsch & Mitzenmacher): ``h1`` is the
digest itself (already uniform — blake2b output), ``h2`` a splitmix64 remix
forced odd, position ``i`` is ``(h1 + i*h2) mod m`` with ``m`` a power of
two so the mod is a mask.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["BloomFilter"]

# splitmix64 finalizer constants (public-domain mixing function).
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_MUL2 = np.uint64(0x94D049BB133111EB)

_MAX_K = 16
_MIN_BITS = 64  # floor so empty/tiny shards still get a valid bitmap


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 (wrapping arithmetic)."""
    z = x + _SM_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SM_MUL1
    z = (z ^ (z >> np.uint64(27))) * _SM_MUL2
    return z ^ (z >> np.uint64(31))


class BloomFilter:
    """Fixed-size Bloom filter over uint64 digests.

    ``bits`` is the packed bitmap (uint8, little-endian bit order within a
    byte); ``k`` the number of probe positions per digest.  Construction
    picks ``m`` as the next power of two ≥ ``n * bits_per_key`` and
    ``k ≈ (m/n) ln 2`` (the FPR-optimal count), so the default 12 bits/key
    lands near a 0.5 % false-positive rate.
    """

    __slots__ = ("bits", "k", "m")

    def __init__(self, bits: np.ndarray, k: int):
        if bits.dtype != np.uint8:
            raise ValueError(f"bitmap must be uint8, got {bits.dtype}")
        self.bits = bits
        self.k = int(k)
        self.m = int(bits.shape[0]) * 8

    # -- construction -------------------------------------------------------

    @staticmethod
    def plan(n: int, bits_per_key: int = 12) -> tuple:
        """The ``(m, k)`` :meth:`build` would choose for ``n`` keys.

        Deterministic in ``(n, bits_per_key)``, so callers can record the
        probe count of an existing sidecar without materializing a bitmap
        (incremental republish skips unchanged shards entirely).
        """
        m = 1 << max(
            _MIN_BITS.bit_length() - 1, (max(1, n) * bits_per_key - 1).bit_length()
        )
        k = int(min(_MAX_K, max(1, round(math.log(2) * m / max(1, n)))))
        return m, k

    @classmethod
    def build(
        cls,
        digests: np.ndarray,
        bits_per_key: int = 12,
        k: Optional[int] = None,
    ) -> "BloomFilter":
        n = int(len(digests))
        m, k_auto = cls.plan(n, bits_per_key)
        k = k_auto if k is None else int(min(k, _MAX_K))
        bits = np.zeros(m // 8, dtype=np.uint8)
        bf = cls(bits, k)
        if n:
            bf.add(digests)
        return bf

    def add(self, digests: np.ndarray) -> None:
        d = np.asarray(digests, dtype=np.uint64)
        h2 = _mix64(d) | np.uint64(1)
        mask = np.uint64(self.m - 1)
        for i in range(self.k):
            pos = (d + np.uint64(i) * h2) & mask
            byte_idx = (pos >> np.uint64(3)).astype(np.int64)
            bit = np.left_shift(
                np.uint8(1), (pos & np.uint64(7)).astype(np.uint8)
            )
            np.bitwise_or.at(self.bits, byte_idx, bit)

    # -- queries ------------------------------------------------------------

    def contains(self, digests: np.ndarray) -> np.ndarray:
        """Vectorized membership: bool mask, no false negatives.

        All ``k`` probe positions are materialized as one ``(k, n)`` grid and
        tested in a single numpy pass: for the small batches a query service
        coalesces (a handful of keys per shard), ``k`` sequential
        length-``n`` passes were dominated by per-op dispatch overhead, not
        by the probes themselves.
        """
        d = np.asarray(digests, dtype=np.uint64)
        if d.shape[0] == 0:
            return np.ones(0, dtype=bool)
        h2 = _mix64(d) | np.uint64(1)
        i = np.arange(self.k, dtype=np.uint64)[:, None]
        pos = (d[None, :] + i * h2[None, :]) & np.uint64(self.m - 1)
        byte = self.bits[(pos >> np.uint64(3)).astype(np.int64)]
        bit = (byte >> (pos & np.uint64(7)).astype(np.uint8)) & np.uint8(1)
        return bit.all(axis=0)

    # -- diagnostics --------------------------------------------------------

    def expected_fpp(self, n: int) -> float:
        """Theoretical false-positive probability after inserting ``n`` keys."""
        if n <= 0:
            return 0.0
        return (1.0 - math.exp(-self.k * n / self.m)) ** self.k

    @property
    def nbytes(self) -> int:
        return int(self.bits.nbytes)
