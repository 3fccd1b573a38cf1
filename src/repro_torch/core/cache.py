"""Scan-resistant record-content cache — the layer in front of the store.

Extraction re-runs (the paper's "re-extraction with modified criteria, no
index rebuild", Table II) and the training loader's epoch loops fetch the
same records over and over.  The byte-offset index makes each fetch O(1)
in *seeks*, but every fetch still pays a ``pread`` plus — far more
expensive at our record sizes — a full structural re-parse for defensive
verification.  This cache remembers both: the raw record text *and* the
canonical id recomputed from it, keyed by the record's physical location
``(file_id, offset)``.

Payloads may be decoded strings or zero-copy
:class:`~repro_torch.core.iobackend.RecordView` windows — the cache is
agnostic (byte accounting uses ``len()``, identical for both).  Caching
the *view* keeps the read path copy-free end to end: the entry pins its
span buffer only until some consumer decodes it (``RecordView.text``
memoizes the string and drops the buffer reference in place, so the
cached entry itself stops pinning at the first delivery).

Location keys (not identifier keys) make the cache correct under every
key_mode: hashed-key collisions map two different lookup keys to one
location, and the cache serves both from a single entry while the
verification compare still runs against each caller's expected id.

Admission is **segmented LRU** (SLRU): a new entry enters a probationary
segment and is only *promoted* to the protected segment when it is hit
again.  Eviction always drains probation first, so one bulk extraction
sweep — millions of records touched exactly once — churns through
probation without evicting the serving working set that earned its place
in protected.  A plain LRU would flush everything on every sweep; with
the query service sharing one cache between bulk extraction and
high-concurrency serving, that failure mode is the default workload.

Entries are evicted by record count and optionally by total cached
bytes.  All operations are thread-safe (the extraction engine's file
workers and the service's reader share one cache), and
hit/miss/eviction/promotion counters are kept for the benchmarks'
cache-hit-rate rows.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["CacheStats", "RecordCache"]

# Fraction of ``capacity`` the protected segment may hold.  Promotion past
# this demotes the protected LRU back to probation (second-chance), never
# evicts it outright.
DEFAULT_PROTECTED_FRAC = 0.8


@dataclass
class CacheStats:
    """Cumulative counters across the cache's lifetime."""

    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserts: int = 0
    probation_hits: int = 0  # hits that found the entry still on probation
    demotions: int = 0       # protected LRU pushed back to probation

    @property
    def promotions(self) -> int:
        """Probation -> protected moves.  Promotion happens exactly on a
        probation hit, so this is derived, not separately counted — one
        fact, one counter."""
        return self.probation_hits

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class RecordCache:
    """SLRU cache of ``(file_id, offset) -> (record_payload, recomputed_id)``.

    ``record_payload`` is the record text as a ``str`` or an undecoded
    :class:`~repro_torch.core.iobackend.RecordView` (the engine caches views;
    they decode lazily at the API boundary).

    ``recomputed_id`` is the canonical id re-derived from the record's
    structural data (``canonical_id_from_structure``), or ``None`` when the
    entry was inserted without verification.  Caching the recomputed id is
    what makes a warm cache fast: a verified re-fetch becomes one dict
    lookup plus one id compare — no I/O, no parse.

    ``capacity`` bounds the total entry count across both segments;
    ``max_bytes`` (optional) additionally bounds the total cached record
    text, so one pathological corpus of huge records cannot blow the
    memory budget.  ``protected_frac`` caps the protected segment's share
    of ``capacity`` (the rest is guaranteed probation room, so admission
    never starves).
    """

    def __init__(
        self,
        capacity: int = 4096,
        max_bytes: Optional[int] = None,
        protected_frac: float = DEFAULT_PROTECTED_FRAC,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        if not 0.0 < protected_frac <= 1.0:
            raise ValueError(
                f"protected_frac must be in (0, 1], got {protected_frac}"
            )
        self.capacity = capacity
        self.max_bytes = max_bytes
        # Protected may never fill the whole cache: probation-first
        # eviction would then evict every NEW entry on arrival and the
        # cache could fossilize around a pinned protected set.  Capping at
        # capacity-1 keeps at least one admission slot; at capacity=1 the
        # cap is 0 and the cache degrades to a plain LRU of one (no
        # promotion).
        self.protected_capacity = min(
            capacity - 1, max(1, int(capacity * protected_frac))
        ) if capacity > 1 else 0
        self.stats = CacheStats()
        self._lock = threading.Lock()
        # Two LRU segments; an entry lives in exactly one at a time.
        self._probation: "OrderedDict[Tuple[str, int], Tuple[str, Optional[str]]]" = (
            OrderedDict()
        )
        self._protected: "OrderedDict[Tuple[str, int], Tuple[str, Optional[str]]]" = (
            OrderedDict()
        )
        self._bytes = 0

    # -- core operations ----------------------------------------------------

    def get(self, file_id: str, offset: int) -> Optional[Tuple[str, Optional[str]]]:
        """``(text, recomputed_id)`` for a cached location, else ``None``."""
        key = (file_id, offset)
        with self._lock:
            entry = self._protected.get(key)
            if entry is not None:
                self._protected.move_to_end(key)
                self.stats.hits += 1
                return entry
            entry = self._probation.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            self.stats.hits += 1
            if self.protected_capacity == 0:
                self._probation.move_to_end(key)  # plain LRU degenerate
                return entry
            # second reference: the entry earned protection
            self.stats.probation_hits += 1
            del self._probation[key]
            self._protected[key] = entry
            while len(self._protected) > self.protected_capacity:
                dkey, dval = self._protected.popitem(last=False)
                self._probation[dkey] = dval  # demote, don't evict
                self.stats.demotions += 1
            return entry

    def put(
        self,
        file_id: str,
        offset: int,
        text,  # str | RecordView
        recomputed_id: Optional[str] = None,
    ) -> None:
        """Insert or refresh an entry (refresh promotes to its segment's MRU).

        A *new* entry always enters probation — one reference is no claim
        on the working set; promotion happens on the next :meth:`get`.  A
        refresh stays in whichever segment the entry already occupies.
        Refreshing never *forgets* a recomputed id: an insert with
        ``recomputed_id=None`` over an already-verified entry keeps the
        verified id (recomputation is deterministic, so the stored id stays
        correct for the unchanged text).
        """
        key = (file_id, offset)
        with self._lock:
            seg = None
            old = self._protected.pop(key, None)
            if old is not None:
                seg = self._protected
            else:
                old = self._probation.pop(key, None)
                if old is not None:
                    seg = self._probation
            if old is not None:
                self._bytes -= len(old[0])
                if recomputed_id is None:
                    recomputed_id = old[1]
            else:
                seg = self._probation
                self.stats.inserts += 1
            seg[key] = (text, recomputed_id)
            self._bytes += len(text)
            self._evict_over_budget()

    def _evict_over_budget(self) -> None:
        """Evict probation-first until count and byte budgets hold.

        "Probation-first" must not mean "newcomer-first": when probation
        holds only the entry being admitted (the byte budget can reach
        this state — promotions move entries without freeing bytes), the
        victim comes from protected instead, or the cache would fossilize
        around the old protected set and never admit again.
        """
        while len(self._probation) + len(self._protected) > self.capacity or (
            self.max_bytes is not None
            and self._bytes > self.max_bytes
            and len(self._probation) + len(self._protected) > 1
        ):
            if len(self._probation) > 1 or not self._protected:
                victim_seg = self._probation
            else:
                victim_seg = self._protected
            _, (etext, _) = victim_seg.popitem(last=False)
            self._bytes -= len(etext)
            self.stats.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._probation.clear()
            self._protected.clear()
            self._bytes = 0

    # -- introspection ------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._probation) + len(self._protected)

    def __contains__(self, key: Tuple[str, int]) -> bool:
        with self._lock:
            return key in self._probation or key in self._protected

    @property
    def probation_len(self) -> int:
        with self._lock:
            return len(self._probation)

    @property
    def protected_len(self) -> int:
        with self._lock:
            return len(self._protected)

    @property
    def cached_bytes(self) -> int:
        with self._lock:
            return self._bytes

    @property
    def hit_rate(self) -> float:
        return self.stats.hit_rate
