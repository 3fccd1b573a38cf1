"""The one traffic generator: requests drawn from a mix file's parameters
and the run's seed.

Lengths are stratified draws from the mix's distributions: every block
of ``strata`` consecutive requests draws one length from each of the
distribution's ``strata`` equal-probability bands, the quantile at
``(j + u) / strata`` with ``u`` uniform in [0, 1) from the seed, in an
order the seed permutes (prompt and output lengths independently).  So
every length the distribution (clipped at its ``min`` and ``max``) can
give arrives, each band as often on every seed, and a run's work differs
from seed to seed only by where inside each band its lengths fall.

Prompts are printable ASCII bytes (one token each under the byte
tokenizer, which adds a BOS token in front), drawn afresh for every
request: no two share a prefix.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np

__all__ = ["Traffic", "quantile"]


def quantile(dist: Dict, p: float) -> int:
    """The ``p`` quantile of a length distribution of a mix file, rounded
    and clipped to its ``min`` and ``max``: ``uniform`` over [min, max], or
    ``lognormal`` with ``median`` and ``sigma``."""
    if dist["dist"] == "uniform":
        v = dist["min"] + p * (dist["max"] - dist["min"])
    elif dist["dist"] == "lognormal":
        v = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(p))
    elif dist["dist"] == "fixed":
        v = dist["value"]
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return int(min(max(round(v), dist.get("min", 1)), dist.get("max", 1 << 30)))


class Traffic:
    """Request ``k`` of a run: ``{"k", "text", "prompt_len", "budget",
    "seed"}``.  Requests are made in order of ``k``, each from the run's
    generator, so request ``k`` is the same whatever the timing."""

    def __init__(self, mix: Dict, seed: int):
        self.mix = mix
        self.rng = np.random.Generator(np.random.PCG64(int(seed)))
        self.strata = int(mix["strata"])
        self._made: List[Dict] = []
        self._perms: List[tuple] = []

    def _block(self, b: int):
        while len(self._perms) <= b:
            self._perms.append((self.rng.permutation(self.strata),
                                self.rng.permutation(self.strata)))
        return self._perms[b]

    def request(self, k: int) -> Dict:
        while len(self._made) <= k:
            self._made.append(self._make(len(self._made)))
        return self._made[k]

    def _band(self, j: int) -> float:
        """A probability drawn from the seed inside band ``j``."""
        return min(max((j + self.rng.random()) / self.strata, 1e-9), 1 - 1e-9)

    def _make(self, k: int) -> Dict:
        pp, op = self._block(k // self.strata)
        j = k % self.strata
        n = quantile(self.mix["prompt"], self._band(pp[j]))
        budget = quantile(self.mix["output"], self._band(op[j]))
        text = self.rng.integers(32, 127, size=n - 1, dtype=np.uint8).tobytes().decode("ascii")
        return {"k": k, "text": text, "prompt_len": n, "budget": budget,
                "seed": int(self.rng.integers(0, 2 ** 32, dtype=np.uint64))}

    def batch(self, b: int) -> List[Dict]:
        """Requests ``b * batch .. (b + 1) * batch - 1``."""
        size = int(self.mix["batch"])
        return [self.request(b * size + i) for i in range(size)]
