"""Byte-offset index construction and persistence (Algorithm 2, §IV).

Phase 1 of the paper's architecture: a one-time O(M×S) scan of every record
file builds a persistent ``key → (file, byte_offset)`` map.  The index is
the contract between the data plane and everything above it — extraction
(Algorithm 3), the training data loader, and the checkpoint catalog all
address records through it.

Two key modes reproduce the paper's §VI migration:

* ``key_mode="hashed_key"`` — index keyed by the 27-char digest
  (InChIKey role): smaller and faster, but collision-prone at scale.
* ``key_mode="full_id"``    — index keyed by the full canonical id
  (full-InChI role): deterministic uniqueness, +~27 % storage (Table IV).

Persistence is CSV (paper-faithful: ``identifier,filename,byte_offset``,
human-readable, ~15 % overhead vs binary — §IV.B) plus an optional binary
sidecar (beyond-paper: packed uint64 digests + offsets for O(1) mmap load
into the device sorted-probe path).
"""

from __future__ import annotations

import csv
import hashlib
import multiprocessing as mp
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .identifiers import hashed_key
from .records import RecordStore, extract_property, iter_records
from .sdfgen import PROP_ID, PROP_KEY

__all__ = [
    "ByteOffsetIndex",
    "IndexStats",
    "build_index",
    "scan_file_for_index",
]

_CSV_HEADER = ["identifier", "filename", "byte_offset"]


@dataclass
class IndexStats:
    n_entries: int = 0
    n_files: int = 0
    n_duplicate_keys: int = 0          # same key seen again (collision signal)
    build_seconds: float = 0.0
    bytes_scanned: int = 0


class ByteOffsetIndex:
    """Persistent map ``identifier → (file_name, byte_offset)``.

    Duplicate keys (distinct records hashing to the same key — the paper's
    InChIKey collisions) are *retained*: the primary map keeps the first
    location (matching the paper's index behaviour, where a collision
    silently shadows a record until verification exposes it) and
    ``shadowed`` keeps every additional location so the collision scanner
    can enumerate them without a second corpus pass.
    """

    def __init__(self, key_mode: str = "full_id"):
        if key_mode not in ("full_id", "hashed_key"):
            raise ValueError(f"bad key_mode {key_mode!r}")
        self.key_mode = key_mode
        self.entries: Dict[str, Tuple[str, int]] = {}
        self.shadowed: Dict[str, List[Tuple[str, int]]] = {}
        self.stats = IndexStats()

    # -- construction -----------------------------------------------------

    def add(self, key: str, file_name: str, offset: int) -> None:
        if key in self.entries:
            self.shadowed.setdefault(key, []).append((file_name, offset))
            self.stats.n_duplicate_keys += 1
        else:
            self.entries[key] = (file_name, offset)

    def merge(self, other: "ByteOffsetIndex") -> None:
        """Dictionary-union merge of a worker's partial index (Alg. 2 l.15-17)."""
        for k, loc in other.entries.items():
            self.add(k, *loc)
        for k, locs in other.shadowed.items():
            for loc in locs:
                self.shadowed.setdefault(k, []).append(loc)
                self.stats.n_duplicate_keys += 1

    # -- queries ----------------------------------------------------------

    def lookup(self, key: str) -> Optional[Tuple[str, int]]:
        return self.entries.get(key)

    def locate_batch(
        self, keys: Sequence[str]
    ) -> List[Optional[Tuple[str, int]]]:
        """Batched lookup — the read contract shared with ``IndexStore``.

        Consumers (extraction planning, the data pipeline) call this once
        per batch instead of ``lookup`` per key, so swapping the dict for
        the sharded mmap store changes nothing above the call site.
        """
        return [self.entries.get(k) for k in keys]

    def iter_keys(self) -> Iterable[str]:
        """Key enumeration shared by every index backend."""
        return iter(self.entries.keys())

    def __len__(self) -> int:
        return len(self.entries)

    def __contains__(self, key: str) -> bool:
        return key in self.entries

    # -- persistence (paper-faithful CSV) -----------------------------------

    def save_csv(self, path: Path) -> int:
        """Write ``identifier,filename,byte_offset`` rows; returns file size."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        with open(tmp, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(_CSV_HEADER)
            for key, (fname, off) in self.entries.items():
                w.writerow([key, fname, off])
            for key, locs in self.shadowed.items():
                for fname, off in locs:
                    w.writerow([key, fname, off])
        os.replace(tmp, path)  # atomic publish
        return path.stat().st_size

    @classmethod
    def load_csv(cls, path: Path, key_mode: str = "full_id") -> "ByteOffsetIndex":
        idx = cls(key_mode=key_mode)
        with open(path, newline="") as f:
            r = csv.reader(f)
            header = next(r)
            if header != _CSV_HEADER:
                raise ValueError(f"unexpected index header {header!r}")
            for key, fname, off in r:
                idx.add(key, fname, int(off))
        idx.stats.n_entries = len(idx)
        return idx

    # -- incremental updates (paper §VIII future work, implemented) ----------

    def drop_file(self, file_name: str) -> int:
        """Remove every entry that points into ``file_name``."""
        doomed = [k for k, (f, _) in self.entries.items() if f == file_name]
        for k in doomed:
            del self.entries[k]
        for k in list(self.shadowed):
            self.shadowed[k] = [
                loc for loc in self.shadowed[k] if loc[0] != file_name
            ]
            if not self.shadowed[k]:
                del self.shadowed[k]
        # promote shadowed entries whose primary vanished
        for k, locs in list(self.shadowed.items()):
            if k not in self.entries and locs:
                self.entries[k] = locs.pop(0)
                if not locs:
                    del self.shadowed[k]
        return len(doomed)

    # -- persistence (binary sidecar: packed digests for the device probe path) --

    def save_binary(self, path: Path) -> Tuple[Path, int]:
        """npz sidecar: uint64 digest of each key + file ids + offsets.

        Digests here are *pointers into the CSV truth*, not identifiers of
        record content — the probe path resolves candidate hits and then
        verifies against the full key, exactly like Algorithm 3's defensive
        validation (a digest collision degrades to an extra verify, never to
        a wrong record).

        The ``.npz`` suffix is normalized up front (``np.savez`` appends it
        when missing), and the written path is returned with its size so
        the reported size always refers to the file actually on disk.
        """
        path = Path(path)
        if path.suffix != ".npz":
            path = path.with_name(path.name + ".npz")
        keys: List[str] = []
        fnames: List[str] = []
        offs: List[int] = []
        for key, (fname, off) in self.entries.items():
            keys.append(key)
            fnames.append(fname)
            offs.append(off)
        file_names = sorted(set(fnames))
        file_ids = {n: i for i, n in enumerate(file_names)}
        digests = np.array(
            [np.uint64(int.from_bytes(hashlib.blake2b(k.encode(), digest_size=8).digest(), "big"))
             for k in keys],
            dtype=np.uint64,
        )
        order = np.argsort(digests, kind="stable")
        np.savez(
            path,
            digests=digests[order],
            file_ids=np.array([file_ids[n] for n in fnames], dtype=np.int32)[order],
            offsets=np.array(offs, dtype=np.int64)[order],
            file_names=np.array(file_names),
            keys=np.array(keys, dtype=object)[order].astype(str),
            key_mode=np.array(self.key_mode),
        )
        return path, path.stat().st_size

    def save_sharded(
        self,
        root: Path,
        n_shards: int = 16,
        digest_bits: int = 64,
        bloom_bits_per_key: int = 12,
        fingerprint_bits: Optional[int] = 1024,
    ) -> Dict[str, object]:
        """Publish the index as a sharded mmap-backed store directory.

        The serving-grade persistence path (:mod:`repro_torch.core.store`):
        digest-range shards of the packed sidecar columns plus per-shard
        Bloom bitmaps plus — unless ``fingerprint_bits=None`` — packed
        ``fingerprint_bits``-wide fingerprint planes for Tanimoto
        similarity search.  Re-publishing after an incremental
        :func:`update_index` rewrites only shards whose content changed.
        """
        from .store import save_sharded  # local import: store builds on index

        return save_sharded(
            self,
            root,
            n_shards=n_shards,
            digest_bits=digest_bits,
            bloom_bits_per_key=bloom_bits_per_key,
            fingerprint_bits=fingerprint_bits,
        )


class BinaryIndex:
    """mmap-fast sorted-digest index (the device sorted-probe's host twin).

    Loads the npz sidecar written by :meth:`ByteOffsetIndex.save_binary`;
    lookups are a binary search over the uint64 digest column with a full
    string-key verification on hit (Algorithm 3 discipline: a digest
    collision costs a verify, never a wrong record).
    """

    def __init__(self, path: Path):
        p = str(path)
        if not p.endswith(".npz"):
            p += ".npz"
        z = np.load(p, allow_pickle=False)
        self.digests = z["digests"]        # sorted uint64
        self.file_ids = z["file_ids"]
        self.offsets = z["offsets"]
        self.file_names = [str(x) for x in z["file_names"]]
        self.keys = [str(x) for x in z["keys"]]
        # persisted since PR 2; older sidecars predate hashed_key support
        self.key_mode = (
            str(z["key_mode"]) if "key_mode" in z.files else "full_id"
        )

    def __len__(self) -> int:
        return len(self.digests)

    def lookup(self, key: str) -> Optional[Tuple[str, int]]:
        d = np.uint64(
            int.from_bytes(
                hashlib.blake2b(key.encode(), digest_size=8).digest(), "big"
            )
        )
        i = int(np.searchsorted(self.digests, d))
        while i < len(self.digests) and self.digests[i] == d:
            if self.keys[i] == key:  # verify on the full key
                return self.file_names[self.file_ids[i]], int(self.offsets[i])
            i += 1
        return None

    def locate_batch(
        self, keys: Sequence[str]
    ) -> List[Optional[Tuple[str, int]]]:
        """Batched lookup (same read contract as the dict index / IndexStore)."""
        return [self.lookup(k) for k in keys]

    def iter_keys(self) -> Iterable[str]:
        return iter(self.keys)


def scan_file_for_index(
    args: Tuple[str, str, bool, int]
) -> Tuple[str, List[Tuple[str, int]], int]:
    """Worker: scan one SDF file, return ``(file_name, [(key, offset)], bytes)``.

    ProcessFile() from Algorithm 2 — embarrassingly parallel, no
    inter-worker communication.  Module-level function so it pickles for
    ``multiprocessing.Pool``.
    """
    path_s, key_mode, recompute, key_bits = args
    path = Path(path_s)
    out: List[Tuple[str, int]] = []
    for offset, text in iter_records(path):
        if key_mode == "full_id":
            key = extract_property(text, PROP_ID)
        else:
            key = None if recompute else extract_property(text, PROP_KEY)
            if key is None:
                full = extract_property(text, PROP_ID)
                key = hashed_key(full, key_bits) if full else None
        if key is not None:
            out.append((key, offset))
    return path.name, out, path.stat().st_size


def build_index(
    store: RecordStore,
    key_mode: str = "full_id",
    workers: int = 1,
    key_bits: int = 64,
    recompute_keys: bool = False,
) -> ByteOffsetIndex:
    """Phase 1: full corpus scan → persistent byte-offset index.

    ``workers > 1`` uses a process pool over files (Algorithm 2); the merge
    is a dictionary union, as in the paper, taken in ``store.files()``
    order whatever order the workers finish in: where hashed keys collide,
    the first location kept is the one ``workers=1`` keeps, so the index
    does not depend on ``workers``.  O(M×S), incurred once.
    ``recompute_keys`` ignores the embedded hashed-key property and
    re-derives it from the full id at ``key_bits`` (key-width studies).
    """
    t0 = time.perf_counter()
    idx = ByteOffsetIndex(key_mode=key_mode)
    files = store.files()
    args = [(str(p), key_mode, recompute_keys, key_bits) for p in files]
    bytes_scanned = 0
    if workers <= 1:
        results = map(scan_file_for_index, args)
        for fname, pairs, nbytes in results:
            bytes_scanned += nbytes
            for key, off in pairs:
                idx.add(key, fname, off)
    else:
        ctx = mp.get_context("fork" if hasattr(os, "fork") else "spawn")
        with ctx.Pool(processes=workers) as pool:
            for fname, pairs, nbytes in pool.imap(scan_file_for_index, args):
                bytes_scanned += nbytes
                for key, off in pairs:
                    idx.add(key, fname, off)
    idx.stats.n_entries = len(idx)
    idx.stats.n_files = len(files)
    idx.stats.build_seconds = time.perf_counter() - t0
    idx.stats.bytes_scanned = bytes_scanned
    return idx


def file_fingerprints(store: RecordStore) -> Dict[str, Tuple[int, int]]:
    """``name → (size, mtime_ns)`` for change detection.

    This is the change-detection entry point, so it is the one place that
    must see the directory as it is NOW — refresh the store's cached
    listing before fingerprinting.
    """
    return {
        p.name: (p.stat().st_size, p.stat().st_mtime_ns)
        for p in store.refresh().files()
    }


def update_index(
    idx: ByteOffsetIndex,
    store: RecordStore,
    old_fingerprints: Dict[str, Tuple[int, int]],
    key_mode: str = "full_id",
    key_bits: int = 64,
) -> Tuple[Dict[str, Tuple[int, int]], Dict[str, int]]:
    """Incremental index update (the paper's §VIII future work, built).

    Rescans ONLY files that are new or whose (size, mtime) changed, and
    drops entries for files that vanished — O(changed bytes) instead of the
    full O(M×S) rebuild.  Returns (new_fingerprints, change summary).
    """
    new_fp = file_fingerprints(store)
    changed = [
        n for n, fp in new_fp.items() if old_fingerprints.get(n) != fp
    ]
    removed = [n for n in old_fingerprints if n not in new_fp]
    summary = {"rescanned": 0, "dropped": 0, "added": 0}
    for name in removed + changed:
        summary["dropped"] += idx.drop_file(name)
    for name in changed:
        fname, pairs, _ = scan_file_for_index(
            (str(store.path_of(name)), key_mode, False, key_bits)
        )
        for key, off in pairs:
            idx.add(key, fname, off)
            summary["added"] += 1
        summary["rescanned"] += 1
    idx.stats.n_entries = len(idx)
    return new_fp, summary
