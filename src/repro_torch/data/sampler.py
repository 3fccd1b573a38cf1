"""Deterministic, elastic example addressing.

``(step, dp_rank)`` → global example ids → record keys → byte offsets is a
*pure function*: no iterator state exists anywhere.  Consequences, which
are the data-plane half of the fault-tolerance story (DESIGN.md §2):

* checkpointing the data pipeline = saving one integer (the step);
* any worker can compute any other worker's shard (failure hand-off);
* changing the dp extent (elastic rescale) re-partitions the SAME global
  example order — tokens-seen semantics are preserved exactly, because
  example ids are global and only their assignment to ranks changes.

Shuffling is a stateless Feistel permutation over [0, N): pseudo-random,
invertible, O(1) per index, no materialized permutation array (N can be
billions of records at production scale).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Sequence

__all__ = ["FeistelShuffle", "GlobalSampler"]


class FeistelShuffle:
    """Stateless permutation of [0, n) via a 4-round Feistel network.

    Works over the smallest balanced bit-domain ≥ n with cycle-walking to
    stay inside [0, n).
    """

    def __init__(self, n: int, seed: int, rounds: int = 4):
        if n <= 0:
            raise ValueError("n must be positive")
        self.n = n
        self.seed = seed
        self.rounds = rounds
        bits = max(2, (n - 1).bit_length())
        self.half = (bits + 1) // 2
        self.mask = (1 << self.half) - 1
        self.domain = 1 << (2 * self.half)

    def _round_key(self, r: int) -> int:
        h = hashlib.blake2b(
            f"{self.seed}:{r}".encode(), digest_size=8
        ).digest()
        return int.from_bytes(h, "big")

    def _feistel(self, x: int) -> int:
        l = x >> self.half
        r = x & self.mask
        for i in range(self.rounds):
            k = self._round_key(i)
            f = hashlib.blake2b(
                (r ^ (k & self.mask)).to_bytes(8, "big"), digest_size=8
            ).digest()
            l, r = r, l ^ (int.from_bytes(f, "big") & self.mask)
        return (l << self.half) | r

    def __call__(self, i: int) -> int:
        if not 0 <= i < self.n:
            raise IndexError(i)
        x = i
        while True:  # cycle-walk until inside [0, n)
            x = self._feistel(x)
            if x < self.n:
                return x


@dataclass(frozen=True)
class GlobalSampler:
    """Maps (step, dp_rank) → the global example indices of that shard."""

    n_examples: int
    global_batch: int
    seed: int = 0

    def _shuffle(self, epoch: int) -> FeistelShuffle:
        return FeistelShuffle(self.n_examples, self.seed * 1000003 + epoch)

    def example_ids(self, step: int, dp_rank: int, n_dp: int) -> List[int]:
        """Record indices for one dp shard at one step (epoch-wrapped)."""
        if self.global_batch % n_dp:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by dp={n_dp}"
            )
        per = self.global_batch // n_dp
        base = step * self.global_batch + dp_rank * per
        out = []
        for i in range(per):
            g = base + i
            epoch, idx = divmod(g, self.n_examples)
            out.append(self._shuffle(epoch)(idx))
        return out

    def all_ids(self, step: int) -> List[int]:
        return self.example_ids(step, 0, 1)
