"""Eq. 1 — multi-source intersection: D_final = D_A ∩ D_B ∩ D_C.

Two implementations, cross-validated:

* ``intersect_host``   — Python set intersection (the paper's "standard set
  operations on identifier lists", 2.5 h at their scale).
* ``intersect_sorted`` — packed-digest sort-merge on NumPy arrays, the
  device-idiomatic formulation whose inner membership step is what the
  ``sorted_probe`` kernel does on the card.  Digest hits are
  verified on the full string id over the *whole* equal-digest run
  (collision-safe by construction — the same run-scan discipline the
  sharded :class:`repro_torch.core.store.IndexStore` applies), using the shared
  :func:`repro_torch.core.store.digest_u64` / :func:`candidate_runs` helpers
  rather than a private copy.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .store import candidate_runs, digest_u64

__all__ = ["IntersectionResult", "intersect_host", "intersect_sorted", "digest_u64"]


@dataclass
class IntersectionResult:
    ids: List[str]
    seconds: float
    method: str

    @property
    def count(self) -> int:
        return len(self.ids)


def intersect_host(*id_lists: Sequence[str]) -> IntersectionResult:
    t0 = time.perf_counter()
    if not id_lists:
        return IntersectionResult([], 0.0, "host")
    acc = set(id_lists[0])
    for ids in id_lists[1:]:
        acc &= set(ids)
    out = sorted(acc)
    return IntersectionResult(out, time.perf_counter() - t0, "host")


def intersect_sorted(
    *id_lists: Sequence[str], digest_bits: int = 64
) -> IntersectionResult:
    """Sort-merge intersection over packed digests, string-verified.

    The device-friendly formulation: digests of list k+1 are probed against
    the sorted digest table of the running intersection via binary search
    (``np.searchsorted`` here; ``kernels/sorted_probe`` on the card).  Each probe
    inspects the full ``[left, right)`` equal-digest run — a ``side="left"``
    position alone would only verify the first of several colliding table
    digests and silently drop true members behind it.

    ``digest_bits < 64`` narrows the digest space (collision studies and
    tests; mirrors ``hashed_key``'s width knob) — results stay exact because
    of string verification, only the collision rate changes.
    """
    t0 = time.perf_counter()
    if not id_lists:
        return IntersectionResult([], 0.0, "sorted")
    cur_ids: List[str] = list(dict.fromkeys(id_lists[0]))  # dedupe, keep order
    cur_dig = digest_u64(cur_ids, bits=digest_bits)
    order = np.argsort(cur_dig, kind="stable")
    cur_ids = [cur_ids[i] for i in order]
    cur_dig = cur_dig[order]

    for ids in id_lists[1:]:
        probe_ids = list(dict.fromkeys(ids))
        probe_dig = digest_u64(probe_ids, bits=digest_bits)
        starts, stops = candidate_runs(cur_dig, probe_dig)
        keep_ids: List[str] = []
        keep_dig: List[np.uint64] = []
        for i in np.nonzero(stops > starts)[0]:
            # digest hit -> verify on the full string id, scanning the whole
            # equal-digest run (collision-safe)
            for t in range(int(starts[i]), int(stops[i])):
                if cur_ids[t] == probe_ids[i]:
                    keep_ids.append(probe_ids[i])
                    keep_dig.append(probe_dig[i])
                    break
        kd = np.array(keep_dig, dtype=np.uint64)
        order = np.argsort(kd, kind="stable")
        cur_ids = [keep_ids[i] for i in order]
        cur_dig = kd[order]

    out = sorted(cur_ids)
    return IntersectionResult(out, time.perf_counter() - t0, "sorted")
