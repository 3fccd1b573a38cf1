"""Deterministic multi-corpus mixture sampling.

Production pretraining draws from several corpora with domain weights
(e.g. validated-intersection data upweighted vs raw single-source data —
exactly the quality tiers the paper's integration funnel produces).  This
sampler keeps the data-plane invariants of :mod:`repro_torch.data.sampler`:

* ``(step, slot)`` → (corpus, example) is a **pure function** — the
  checkpoint is still one integer, elastic re-shard still exact;
* corpus choice per global slot uses a stateless hash (no RNG state),
  so any worker can recompute any other worker's draw;
* within a corpus, examples follow that corpus's own Feistel shuffle
  epoch-by-epoch (no example skipped or repeated within an epoch of the
  per-corpus stream).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .sampler import FeistelShuffle

__all__ = ["MixtureSampler"]


def _hash01(seed: int, x: int) -> float:
    h = hashlib.blake2b(f"{seed}:{x}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "big") / 2**64


@dataclass(frozen=True)
class MixtureSampler:
    """Weighted mixture over K corpora with stateless addressing."""

    sizes: Tuple[int, ...]            # examples per corpus
    weights: Tuple[float, ...]        # sampling weights (normalized)
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        if len(self.sizes) != len(self.weights):
            raise ValueError("sizes/weights length mismatch")
        if any(w < 0 for w in self.weights) or sum(self.weights) <= 0:
            raise ValueError("weights must be non-negative, sum > 0")

    def _corpus_for(self, g: int) -> int:
        """Corpus of global slot ``g`` (stateless categorical draw)."""
        u = _hash01(self.seed * 7919 + 1, g)
        total = sum(self.weights)
        acc = 0.0
        for i, w in enumerate(self.weights):
            acc += w / total
            if u < acc:
                return i
        return len(self.weights) - 1

    def _rank_within_corpus(self, g: int, corpus: int) -> int:
        """How many slots before ``g`` chose ``corpus`` (pure in (seed, g)).

        Exact counting, memoized monotonically per (sampler-identity,
        corpus): amortized O(1) per sequential slot, O(g) worst case on a
        cold jump — still a pure function of the inputs, so determinism
        and elasticity are preserved.
        """
        key = (self.seed, self.sizes, self.weights, corpus)
        cache = _rank_cache.setdefault(key, {0: 0})  # rank before slot 0
        if g in cache:
            return cache[g]
        gmax = max(k for k in cache if k <= g)
        rank = cache[gmax]
        for x in range(gmax, g):
            if self._corpus_for(x) == corpus:
                rank += 1
        cache[g] = rank
        return rank

    def example_for_slot(self, g: int) -> Tuple[int, int]:
        """global slot → (corpus index, example index within corpus)."""
        c = self._corpus_for(g)
        r = self._rank_within_corpus(g, c)
        n = self.sizes[c]
        epoch, idx = divmod(r, n)
        shuf = FeistelShuffle(n, self.seed * 1000003 + 31 * c + epoch)
        return c, shuf(idx)

    def batch_slots(self, step: int, dp_rank: int, n_dp: int) -> List[int]:
        if self.global_batch % n_dp:
            raise ValueError("global_batch not divisible by dp")
        per = self.global_batch // n_dp
        base = step * self.global_batch + dp_rank * per
        return list(range(base, base + per))

    def batch_examples(
        self, step: int, dp_rank: int, n_dp: int
    ) -> List[Tuple[int, int]]:
        return [self.example_for_slot(g) for g in self.batch_slots(step, dp_rank, n_dp)]


_rank_cache: Dict[tuple, Dict[int, int]] = {}
