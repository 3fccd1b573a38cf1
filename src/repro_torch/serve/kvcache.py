"""Paged KV cache bookkeeping: a free-list block allocator + block tables.

The device side of the paged cache is a fixed-shape block pool per layer
(:func:`repro_torch.models.transformer.lm_paged_cache_init`): P = n_blocks
× block_size KV rows, where block ``i`` owns rows [i*bs, (i+1)*bs).  This
module owns the HOST side: which blocks belong to which batch slot.  It
is plain numpy/python — no torch — so admission decisions never touch the
device, and the only thing the decode step uploads after an admission or
an eviction is the small (slots, max_blocks) int32 table.  A copy of the
reference package's module under the same names, so the same operation
sequences leave both in the same state.

Design points (the paged-attention serving pattern):

* **Fixed pool, free-list reuse.**  Blocks are preallocated once; alloc
  pops from a LIFO free list and free pushes back, so slot churn reuses
  hot HBM rows instead of fragmenting them.  Allocation order is
  deterministic — byte-parity tests lean on a freed-and-reused table
  producing the same gathers as a fresh one.
* **Trash block 0.**  Table entries of unallocated positions (and whole
  rows of inactive slots) point at reserved block 0.  Writes from masked
  lanes land there harmlessly; reads from it are always masked by the
  position-validity mask (``idx <= pos``), so its contents are never
  observable.
* **Reserve-at-admission.**  ``admit(slot, total_len)`` reserves every
  block the request can touch (prompt + decode budget) up front.  A
  request therefore either admits whole or waits — pool exhaustion is
  admission backpressure, never a mid-decode stall that would need
  preemption machinery.  (On-demand growth exists as ``grow`` for the
  cache tests.)
* **Refcounted sharing + copy-on-write.**  Every allocated block carries
  a refcount: one per slot that addresses it and one per
  :class:`PrefixIndex` entry that keeps it resident.  ``ref``/``unref``
  move a block between holders; a block returns to the free list only at
  refcount 0, and ``fork`` swaps a shared block out of a slot's table
  for a private copy (the caller copies the device rows) so a write can
  never be observed through another holder's table.  The trash block is
  never refcounted and never shared.

:class:`PrefixIndex` is the deduplication layer on top: the serving
analogue of the paper's byte-offset index.  Where the index maps an
InChI key to the byte span that already holds its record (so extraction
never re-reads what it has), the prefix index maps a rolling hash of
full token blocks to the resident block chain that already holds that
prompt prefix's KV — so admission adopts the blocks (refcount bump)
instead of re-running prefill over them.  Entries verify the exact
token prefix before adoption (a hash collision is a miss, never a wrong
share), and LRU eviction drops index-only (refcount-1) entries under
pool pressure.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BlockManager",
    "PagedCacheSpec",
    "PrefixIndex",
    "TRASH_BLOCK",
    "blocks_for",
    "rolling_block_hashes",
]

TRASH_BLOCK = 0

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer — deterministic across processes (unlike
    ``hash``), cheap enough for ≤32-token blocks."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def rolling_block_hashes(
    tokens: Sequence[int], block_size: int, n_blocks: int
) -> List[int]:
    """Rolling hash per full token block: ``out[j]`` covers blocks 0..j.

    Sequential fold (order-sensitive), so hash j+1 extends hash j without
    rescanning the prefix — probing every block-aligned prefix length of
    a prompt costs one pass over the prompt.
    """
    out: List[int] = []
    h = _mix64(block_size)
    for j in range(n_blocks):
        for t in tokens[j * block_size: (j + 1) * block_size]:
            h = _mix64(h ^ (int(t) & _M64))
        out.append(h)
    return out


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``n_tokens`` KV rows."""
    return max(0, -(-int(n_tokens) // block_size))


@dataclasses.dataclass(frozen=True)
class PagedCacheSpec:
    """Static geometry of one paged cache pool."""

    n_blocks: int           # total blocks incl. the reserved trash block
    block_size: int
    max_slots: int          # decode batch width
    max_blocks_per_seq: int # block-table width M (view length = M * bs)

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 2:
            raise ValueError("n_blocks must be >= 2 (block 0 is the trash block)")
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.max_blocks_per_seq < 1:
            raise ValueError("max_blocks_per_seq must be >= 1")

    @property
    def max_len(self) -> int:
        """Longest sequence (prompt + generated) a slot can address."""
        return self.max_blocks_per_seq * self.block_size

    @property
    def usable_blocks(self) -> int:
        return self.n_blocks - 1  # minus trash

    @property
    def pool_rows(self) -> int:
        return self.n_blocks * self.block_size


class BlockManager:
    """Free-list allocator + per-slot block tables over a fixed pool.

    Blocks are refcounted: ``alloc`` hands them out at refcount 1, ``ref``
    adds a holder (another slot's table, a prefix-index entry), ``unref``
    drops one and returns the block to the free list only at refcount 0.
    ``fork`` swaps a shared block out of one slot's table for a fresh
    private block (copy-on-write — the caller copies the device rows).
    """

    def __init__(self, spec: PagedCacheSpec):
        self.spec = spec
        # LIFO free list: lowest ids allocated first ⇒ deterministic reuse
        self._free: List[int] = list(range(spec.n_blocks - 1, 0, -1))
        self._allocated: set[int] = set()
        self._refcounts: Dict[int, int] = {}
        self._tables = np.full(
            (spec.max_slots, spec.max_blocks_per_seq), TRASH_BLOCK, np.int32
        )
        self._slot_blocks: Dict[int, List[int]] = {}
        self.allocs = 0
        self.frees = 0
        self.alloc_failures = 0     # admission attempts refused (backpressure)
        self.peak_in_use = 0

    # -- raw block ops -------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_in_use(self) -> int:
        return len(self._allocated)

    def refcount(self, block: int) -> int:
        return self._refcounts.get(block, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` blocks at refcount 1, or None (and count a failure) if
        short."""
        if n > len(self._free):
            self.alloc_failures += 1
            return None
        blocks = [self._free.pop() for _ in range(n)]
        self._allocated.update(blocks)
        for b in blocks:
            self._refcounts[b] = 1
        self.allocs += n
        self.peak_in_use = max(self.peak_in_use, len(self._allocated))
        return blocks

    def ref(self, blocks: Sequence[int]) -> None:
        """Add one holder to each block (shared adoption)."""
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("refusing to share the trash block")
            if b not in self._allocated:
                raise ValueError(f"ref of unallocated block {b}")
        for b in blocks:
            self._refcounts[b] += 1

    def unref(self, blocks: Sequence[int]) -> int:
        """Drop one holder from each block; free those reaching refcount 0.

        Returns the number of blocks actually freed.
        """
        freed = 0
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("refusing to unref the trash block")
            rc = self._refcounts.get(b, 0)
            if b not in self._allocated or rc < 1:
                raise ValueError(f"unref of block {b} with no holders")
            if rc == 1:
                del self._refcounts[b]
                self._allocated.remove(b)
                self._free.append(b)
                self.frees += 1
                freed += 1
            else:
                self._refcounts[b] = rc - 1
        return freed

    def free(self, blocks: List[int]) -> None:
        """Return exclusively-held blocks to the free list.

        Shared blocks must go through ``unref`` — freeing one out from
        under another holder is always a bug, so it raises here.
        """
        for b in blocks:
            if b == TRASH_BLOCK:
                raise ValueError("refusing to free the trash block")
            if b not in self._allocated:
                raise ValueError(f"double free of block {b}")
            if self._refcounts.get(b, 0) > 1:
                raise ValueError(f"refusing to free shared block {b} "
                                 f"(refcount {self._refcounts[b]})")
        self.unref(blocks)

    def fork(self, slot: int, block_idx: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write: give ``slot`` a private copy of table entry
        ``block_idx`` before it writes there.

        Returns ``(old, new)`` block ids — the caller copies the device
        rows old→new.  When the block is already exclusive this is a
        no-op ``(b, b)``; when the pool is empty returns None.
        """
        owned = self._slot_blocks.get(slot)
        if owned is None:
            raise ValueError(f"slot {slot} is not admitted")
        if not (0 <= block_idx < len(owned)):
            raise ValueError(f"slot {slot} has no block index {block_idx}")
        b = owned[block_idx]
        if self._refcounts.get(b, 0) <= 1:
            return (b, b)
        fresh = self.alloc(1)
        if fresh is None:
            return None
        new = fresh[0]
        self.unref([b])
        owned[block_idx] = new
        self._tables[slot, block_idx] = new
        return (b, new)

    # -- slot lifecycle ------------------------------------------------------

    def can_admit(self, total_len: int, n_adopted: int = 0) -> bool:
        """Would ``admit`` succeed for a sequence of ``total_len`` tokens,
        ``n_adopted`` of whose blocks are adopted from the prefix index?"""
        need = blocks_for(total_len, self.spec.block_size)
        return (need <= self.spec.max_blocks_per_seq
                and need - n_adopted <= len(self._free))

    def admit(
        self,
        slot: int,
        total_len: int,
        prefix_blocks: Optional[Sequence[int]] = None,
    ) -> bool:
        """Reserve every block of a ``total_len``-token sequence for ``slot``.

        ``prefix_blocks`` are already-resident shared blocks (from a
        :class:`PrefixIndex` match) adopted as the head of the slot's
        chain: they are ref'd, not allocated, and only the remainder
        comes off the free list.  Returns False (and leaves state
        untouched) when the pool can't cover the remainder — the caller
        keeps the request queued.
        """
        if slot in self._slot_blocks:
            raise ValueError(f"slot {slot} is already admitted")
        adopted = list(prefix_blocks or [])
        need = blocks_for(total_len, self.spec.block_size)
        if need > self.spec.max_blocks_per_seq:
            raise ValueError(
                f"sequence of {total_len} tokens needs {need} blocks > "
                f"table width {self.spec.max_blocks_per_seq} "
                f"(max_len {self.spec.max_len})"
            )
        if len(adopted) > need:
            raise ValueError(
                f"{len(adopted)} adopted blocks exceed the {need} the "
                f"sequence needs"
            )
        # whole-or-nothing: check the free list before taking any refs
        if need - len(adopted) > len(self._free):
            self.alloc_failures += 1
            return False
        self.ref(adopted)
        fresh = self.alloc(need - len(adopted))
        assert fresh is not None  # checked above
        blocks = adopted + fresh
        self._slot_blocks[slot] = blocks
        self._tables[slot, :] = TRASH_BLOCK
        self._tables[slot, : len(blocks)] = blocks
        return True

    def grow(self, slot: int, total_len: int) -> bool:
        """Extend ``slot`` to cover ``total_len`` tokens (on-demand mode)."""
        owned = self._slot_blocks.get(slot)
        if owned is None:
            raise ValueError(f"slot {slot} is not admitted")
        need = blocks_for(total_len, self.spec.block_size)
        if need > self.spec.max_blocks_per_seq:
            raise ValueError(f"slot {slot}: {need} blocks exceed table width")
        extra = need - len(owned)
        if extra <= 0:
            return True
        blocks = self.alloc(extra)
        if blocks is None:
            return False
        self._tables[slot, len(owned): len(owned) + extra] = blocks
        owned.extend(blocks)
        return True

    def release(self, slot: int) -> None:
        """Drop a finished slot's hold on its blocks.

        Exclusive blocks return to the free list; blocks still held by
        other slots or the prefix index merely lose one refcount.
        """
        blocks = self._slot_blocks.pop(slot, None)
        if blocks is None:
            raise ValueError(f"slot {slot} is not admitted")
        self.unref(blocks)
        self._tables[slot, :] = TRASH_BLOCK

    def slot_blocks(self, slot: int) -> List[int]:
        return list(self._slot_blocks.get(slot, []))

    @property
    def tables(self) -> np.ndarray:
        """The (max_slots, M) int32 block tables (live view — upload, don't
        mutate)."""
        return self._tables

    def check(self, external_refs: Optional[Dict[int, int]] = None) -> None:
        """Assert the allocator invariants (tests + debug).

        ``external_refs`` maps block → refs held by non-slot holders
        (e.g. :meth:`PrefixIndex.block_refs`); when given, refcounts are
        validated *exactly* — slot holds + external holds must equal the
        recorded refcount for every allocated block.
        """
        owned: Dict[int, int] = {}
        for bs in self._slot_blocks.values():
            # a slot's own chain never repeats a block
            assert len(bs) == len(set(bs)), "slot chain repeats a block"
            for b in bs:
                owned[b] = owned.get(b, 0) + 1
        # raw alloc() without a slot assignment is legal (mid-admission),
        # but a slot must never own a block the allocator doesn't know
        assert set(owned) <= self._allocated, "slot owns unallocated block"
        assert not (set(self._free) & self._allocated), "block both free and used"
        assert len(self._free) + len(self._allocated) == self.spec.n_blocks - 1
        assert TRASH_BLOCK not in self._allocated
        live = set(np.unique(self._tables)) - {TRASH_BLOCK}
        assert live <= self._allocated, "table points at unallocated block"
        # refcount consistency
        assert set(self._refcounts) == self._allocated, \
            "refcounts out of sync with allocated set"
        for b, rc in self._refcounts.items():
            assert rc >= 1, f"allocated block {b} has refcount {rc}"
            held = owned.get(b, 0)
            if external_refs is None:
                assert held <= rc, \
                    f"block {b}: {held} slot holders exceed refcount {rc}"
            else:
                total = held + external_refs.get(b, 0)
                assert total == rc, (
                    f"block {b}: refcount {rc} != {held} slot holders + "
                    f"{external_refs.get(b, 0)} external refs"
                )
        if external_refs is not None:
            assert set(external_refs) <= self._allocated, \
                "external ref on unallocated block"

    def stats(self) -> Dict[str, int]:
        return {
            "n_blocks": self.spec.n_blocks,
            "block_size": self.spec.block_size,
            "in_use": self.n_in_use,
            "free": self.n_free,
            "allocs": self.allocs,
            "frees": self.frees,
            "alloc_failures": self.alloc_failures,
            "peak_in_use": self.peak_in_use,
            "shared_blocks": sum(1 for rc in self._refcounts.values() if rc > 1),
        }


class PrefixIndex:
    """Hash index over block-aligned prompt prefixes → resident block chains.

    Each entry is keyed by the rolling hash of its full token blocks and
    holds one refcount on every block of its chain, so the KV stays
    resident after the owning slot finishes.  ``match`` verifies the
    exact token prefix before reporting a hit (hash collisions are
    misses, never wrong adoptions) and refreshes LRU order;
    ``evict_for`` walks LRU→MRU under pool pressure, dropping only
    entries that actually return blocks to the free list (i.e. contain
    refcount-1 blocks) — an entry shared with an active slot is skipped,
    never freed out from under it.
    """

    def __init__(self, mgr: BlockManager, max_entries: Optional[int] = None):
        self.mgr = mgr
        self.block_size = mgr.spec.block_size
        self.max_entries = max_entries
        # hash → (token tuple, block chain); insertion/touch order = LRU
        self._entries: "OrderedDict[int, Tuple[Tuple[int, ...], List[int]]]" = (
            OrderedDict()
        )
        self.hits = 0
        self.misses = 0
        self.inserts = 0
        self.evictions = 0
        self.hash_collisions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def match(self, prompt: Sequence[int]) -> Tuple[List[int], int]:
        """Longest resident block-aligned prefix of ``prompt``.

        Returns ``(blocks, n_tokens)`` with ``n_tokens = len(blocks) *
        block_size``, or ``([], 0)`` on a miss.  Adoption is capped at
        ``(len(prompt) - 1) // block_size`` blocks so at least one
        prompt token is always left to prefill (the suffix pass is what
        produces the last-position logits).  The returned blocks are NOT
        ref'd — pass them to :meth:`BlockManager.admit` as
        ``prefix_blocks`` before anything else can evict them.
        """
        bs = self.block_size
        n_full = (len(prompt) - 1) // bs
        if n_full <= 0 or not self._entries:
            self.misses += 1
            return [], 0
        hashes = rolling_block_hashes(prompt, bs, n_full)
        for j in range(n_full - 1, -1, -1):
            ent = self._entries.get(hashes[j])
            if ent is None:
                continue
            tokens, blocks = ent
            if tokens != tuple(int(t) for t in prompt[: (j + 1) * bs]):
                self.hash_collisions += 1
                continue
            self._entries.move_to_end(hashes[j])
            self.hits += 1
            return list(blocks), (j + 1) * bs
        self.misses += 1
        return [], 0

    def publish(
        self, prompt: Sequence[int], blocks: Sequence[int], n_tokens: int
    ) -> int:
        """Register every full-block prefix of ``prompt[:n_tokens]`` whose
        KV lives in ``blocks``.

        Each new entry refs its whole chain (blocks 0..j), keeping the
        prefix resident independent of the publishing slot's lifetime.
        Returns the number of entries inserted.
        """
        bs = self.block_size
        n_full = min(int(n_tokens) // bs, len(blocks))
        if n_full <= 0:
            return 0
        hashes = rolling_block_hashes(prompt, bs, n_full)
        added = 0
        for j in range(n_full):
            key = hashes[j]
            tokens = tuple(int(t) for t in prompt[: (j + 1) * bs])
            ent = self._entries.get(key)
            if ent is not None:
                if ent[0] != tokens:
                    self.hash_collisions += 1  # keep the resident entry
                else:
                    self._entries.move_to_end(key)
                continue
            if self.max_entries is not None and len(self._entries) >= self.max_entries:
                if self.evict_lru() == 0:
                    break
            chain = [int(b) for b in blocks[: j + 1]]
            self.mgr.ref(chain)
            self._entries[key] = (tokens, chain)
            self.inserts += 1
            added += 1
        return added

    def _drop(self, key: int) -> int:
        """Remove one entry, unref its chain; returns blocks freed."""
        _, chain = self._entries.pop(key)
        self.evictions += 1
        return self.mgr.unref(chain)

    def evict_lru(self) -> int:
        """Evict the least-recently-used droppable entry (one with at
        least one refcount-1 block).  Returns blocks freed (0 = nothing
        droppable)."""
        for key, (_, chain) in self._entries.items():
            if any(self.mgr.refcount(b) == 1 for b in chain):
                return self._drop(key)
        return 0

    def evict_for(self, need: int) -> int:
        """Free at least ``need`` blocks by LRU eviction, if possible.

        Walks LRU→MRU repeatedly; entries whose blocks are all shared
        with live holders are skipped (evicting them frees nothing and
        loses index coverage).  Returns the number of blocks freed,
        which may be < ``need`` when the index runs dry.
        """
        freed = 0
        while freed < need:
            got = self.evict_lru()
            if got == 0:
                break
            freed += got
        return freed

    def clear(self) -> int:
        """Drop every entry (shutdown / tests).  Returns blocks freed."""
        freed = 0
        for key in list(self._entries):
            freed += self._drop(key)
        return freed

    def block_refs(self) -> Dict[int, int]:
        """Refs held by the index per block — feed to
        :meth:`BlockManager.check` for exact refcount validation."""
        refs: Dict[int, int] = {}
        for _, chain in self._entries.values():
            for b in chain:
                refs[b] = refs.get(b, 0) + 1
        return refs

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "inserts": self.inserts,
            "evictions": self.evictions,
            "hash_collisions": self.hash_collisions,
        }
