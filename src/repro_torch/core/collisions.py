"""§VI — systematic hashed-key collision discovery and analysis.

The paper's most striking empirical result: 163 InChIKey values in PubChem
map to multiple distinct full InChI strings (326 records), ~10× the
birthday-bound expectation of n²/2h ≈ 15.7.  This module reproduces the
*methodology*:

* ``scan_corpus``      — full-corpus scan collecting (hashed_key, full_id)
  pairs and grouping them (the paper's "systematic scanning of the entire
  PubChem index").  Host-dict implementation (exact).
* ``scan_pairs_sorted``— the array-idiomatic equivalent: hash → sort →
  adjacent-compare on 8-byte digests (NumPy; the reference package's
  ``blake2b`` digest, so its groups are the reference's).  Cross-validated
  against the dict path in tests.
* ``birthday_expectation`` — Eq. 5: E[collisions] ≈ n²/(2h).

With the key width set to the paper's h ≈ 1e15 our container-scale corpora
produce ~0 collisions (as theory says they should at n ≤ 1e6); the
benchmarks therefore sweep the key width downward and verify measured
collision counts track n²/2h — the same validation logic, scale-adjusted.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .identifiers import hashed_key
from .records import RecordStore, extract_property, iter_records
from .sdfgen import PROP_ID

__all__ = [
    "CollisionReport",
    "scan_corpus",
    "collisions_from_pairs",
    "scan_pairs_sorted",
    "birthday_expectation",
]


@dataclass
class CollisionReport:
    n_records: int = 0
    key_bits: int = 0
    # key -> list of distinct full ids sharing it (only keys with >= 2)
    colliding: Dict[str, List[str]] = field(default_factory=dict)
    seconds: float = 0.0

    @property
    def n_colliding_keys(self) -> int:
        return len(self.colliding)

    @property
    def n_affected_records(self) -> int:
        return sum(len(v) for v in self.colliding.values())

    @property
    def empirical_rate(self) -> float:
        """Eq. 4: affected records / total records."""
        return self.n_affected_records / self.n_records if self.n_records else 0.0


def birthday_expectation(n_records: int, key_bits: int) -> float:
    """Eq. 5: E[collisions] ≈ n² / (2h) with h = 2**key_bits."""
    return (float(n_records) ** 2) / (2.0 * float(2 ** key_bits))


def collisions_from_pairs(
    pairs: Iterable[Tuple[str, str]]
) -> Dict[str, List[str]]:
    """Group (key, full_id) pairs; return keys with >= 2 *distinct* ids.

    Distinctness matters: the same molecule indexed twice is a duplicate,
    not a collision (the paper's count is of distinct-structure pairs).
    """
    groups: Dict[str, set] = {}
    for key, full_id in pairs:
        groups.setdefault(key, set()).add(full_id)
    return {k: sorted(v) for k, v in groups.items() if len(v) >= 2}


def scan_corpus(
    store: RecordStore, key_bits: int
) -> CollisionReport:
    """Full-corpus collision scan (host-exact reference path)."""
    t0 = time.perf_counter()
    pairs: List[Tuple[str, str]] = []
    n = 0
    for path in store.files():
        for _off, text in iter_records(path):
            full_id = extract_property(text, PROP_ID)
            if full_id is None:
                continue
            n += 1
            pairs.append((hashed_key(full_id, key_bits), full_id))
    rep = CollisionReport(
        n_records=n,
        key_bits=key_bits,
        colliding=collisions_from_pairs(pairs),
        seconds=time.perf_counter() - t0,
    )
    return rep


def scan_pairs_sorted(
    keys: Sequence[str], full_ids: Sequence[str]
) -> Dict[str, List[str]]:
    """Sort-based collision detection (the array-idiomatic substitution).

    Hash-map "group by key" does not map to a device; sort +
    adjacent-compare does.  Keys are mapped to uint64 digests, argsorted,
    and runs of equal digests are checked for distinct full ids.  Digest equality is then
    confirmed on the *string* key (guards against digest aliasing, mirroring
    Algorithm 3's verify-at-the-end discipline).
    """
    if len(keys) != len(full_ids):
        raise ValueError("length mismatch")
    n = len(keys)
    if n == 0:
        return {}
    import hashlib

    dig = np.fromiter(
        (
            int.from_bytes(hashlib.blake2b(k.encode(), digest_size=8).digest(), "big")
            for k in keys
        ),
        dtype=np.uint64,
        count=n,
    )
    order = np.argsort(dig, kind="stable")
    ds = dig[order]
    # run boundaries: ds[i] == ds[i+1]
    eq = ds[1:] == ds[:-1]
    out: Dict[str, set] = {}
    i = 0
    while i < n:
        j = i
        while j + 1 < n and eq[j]:
            j += 1
        if j > i:
            # candidate run [i, j]; confirm on string key then group ids
            for a in range(i, j + 1):
                ka = keys[order[a]]
                out.setdefault(ka, set()).add(full_ids[order[a]])
        i = j + 1
    return {k: sorted(v) for k, v in out.items() if len(v) >= 2}
