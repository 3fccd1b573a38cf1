"""Sharded, mmap-backed query service over the byte-offset index.

The dict inside :class:`~repro_torch.core.index.ByteOffsetIndex` is the paper's
§IV.A in-memory index — fine for one host building the index, a non-starter
for serving it at the paper's 176M-compound scale.  This module is the
serving-grade face of the same contract: the index partitioned by digest
range into ``S`` shards, each persisted as packed sorted-digest columns
(the :meth:`ByteOffsetIndex.save_binary` sidecar format, split per column
so every column is ``np.load(..., mmap_mode="r")``-able) plus a Bloom
bitmap, under one JSON manifest:

    store_dir/
      manifest.json              # params, file_names, per-shard meta
      shard_0003.digests.npy     # uint64, sorted ascending within shard
      shard_0003.file_ids.npy    # int32 into manifest["file_names"]
      shard_0003.offsets.npy     # int64 byte offsets
      shard_0003.keys.npy        # |S<w> full keys (the verify column)
      shard_0003.bloom.npy       # packed Bloom bitmap (uint8)
      shard_0003.fps.npy         # (N, W) uint32 fingerprint bit-plane
      shard_0003.fpcounts.npy    # int32 per-row popcounts (union term)

Query model (batch-first — ``lookup_batch(keys)``):

1. **digest** every key once (vectorized blake2b-64, ``digest_u64``);
2. **route** by digest range (``shard_of``: top bits of the digest);
3. **Bloom prefilter** per shard — misses are rejected from a few bit
   probes without ever faulting the shard's data columns in;
4. **probe** survivors against the shard's sorted digest column — host
   ``np.searchsorted``, or the ``sorted_probe`` CUDA kernel over the
   shard's digest table kept on the store's device;
5. **verify** every digest hit against the full key, scanning forward over
   the equal-digest run (Algorithm 3 discipline: a digest collision costs
   an extra compare, never a wrong record).

Shards load lazily and stay mmap'd, so resident memory is O(touched
shards), and an untouched store costs only its manifest.  On the device
side the same holds: a shard's digest column is uploaded to the store's
device once, at its first device probe, as ``(M, 2)`` uint32 ``(hi, lo)``
pairs, kept as a :class:`~repro_torch.kernels.sorted_probe.kernel.ProbeTable`:
a table that takes ``sorted_probe``'s fenced route builds its fences (a
search tree over the table, an eighth of its bytes) there once with it.
``ByteOffsetIndex`` remains the builder: :func:`save_sharded` skips
rewriting shards whose content hash is unchanged, so incremental index
updates republish only the shards they touched.

Beyond exact-key lookup, each shard carries a **fingerprint plane**
(``fps``/``fpcounts`` sidecars, see :mod:`repro_torch.core.fingerprint`):
packed ``(N, W)`` uint32 bit-rows in the same digest-sorted row order as
the data columns, enabling the second query modality —
:meth:`IndexStore.similar_batch` screens a batch of query fingerprints
against every shard's plane with the batched Tanimoto top-k kernel and
merges the per-shard winners into global ``(scores, file_ids, offsets)``.
A shard's plane and counts go to the store's device once, at its first
device scan; replicas of one store share these device tables.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.sorted_probe.kernel import ProbeTable, probe_served
from ..kernels.sorted_probe.ops import sorted_probe
from ..kernels.tanimoto.ops import tanimoto_topk, tanimoto_topk_host
from .bloom import BloomFilter
from .fingerprint import (
    DEFAULT_FP_BITS,
    fingerprint_batch,
    popcount_u32,
    words_for,
)

__all__ = [
    "IndexStore",
    "QueryStats",
    "candidate_runs",
    "digest_u64",
    "merge_similar_topk",
    "save_sharded",
    "shard_of",
]

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1

_COLUMNS = ("digests", "file_ids", "offsets", "keys")


# ---------------------------------------------------------------------------
# Shared digest / probe helpers (also used by core.intersect)
# ---------------------------------------------------------------------------

def digest_u64(ids: Sequence[str], bits: int = 64) -> np.ndarray:
    """blake2b-64 digests of string ids as a uint64 vector.

    ``bits < 64`` truncates to the low ``bits`` bits — the same
    width-narrowing device :func:`repro_torch.core.identifiers.hashed_key` uses to
    make hundred-million-scale collision phenomenology observable (and
    testable) at container-scale corpora.
    """
    if not 1 <= bits <= 64:
        raise ValueError(f"bits must be in [1, 64], got {bits}")
    out = np.fromiter(
        (
            int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(), "big")
            for s in ids
        ),
        dtype=np.uint64,
        count=len(ids),
    )
    if bits < 64:
        out &= np.uint64((1 << bits) - 1)
    return out


def candidate_runs(
    sorted_digests: np.ndarray, query_digests: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-query ``[start, stop)`` bounds of the equal-digest run.

    ``side="left"`` alone only reaches the *first* of several equal digests;
    pairing it with ``side="right"`` exposes the whole run so callers can
    verify every colliding candidate — the discipline
    :meth:`BinaryIndex.lookup` applies per key, vectorized.
    """
    starts = np.searchsorted(sorted_digests, query_digests, side="left")
    stops = np.searchsorted(sorted_digests, query_digests, side="right")
    return starts.astype(np.int64), stops.astype(np.int64)


def shard_of(digests: np.ndarray, n_shards: int, digest_bits: int = 64) -> np.ndarray:
    """Shard id per digest: the top ``log2(n_shards)`` bits of the digest.

    Digest-range partitioning keeps each shard's digest column sorted and
    contiguous in key space, so per-shard binary search stays valid and
    range ownership is a shift, not a table.
    """
    shard_bits = (n_shards - 1).bit_length()
    if n_shards < 1 or n_shards != 1 << shard_bits and n_shards != 1:
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    if n_shards == 1:
        return np.zeros(len(digests), dtype=np.int64)
    if shard_bits > digest_bits:
        raise ValueError(
            f"n_shards={n_shards} needs {shard_bits} bits but digests have "
            f"only {digest_bits}"
        )
    return (digests >> np.uint64(digest_bits - shard_bits)).astype(np.int64)


def _u64_to_pairs(d: np.ndarray) -> np.ndarray:
    """uint64 → (N, 2) uint32 ``(hi, lo)`` pairs (lex order == u64 order)."""
    hi = (d >> np.uint64(32)).astype(np.uint32)
    lo = (d & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.stack([hi, lo], axis=1)


def merge_similar_topk(
    parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]], k: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Merge per-shard ``(scores, file_ids, offsets)`` top-k candidates.

    The cross-shard tie contract: global order is ``(score desc, file_id
    asc, offset asc)`` — shard-local row order is digest order, meaningless
    across shards, so equal Tanimoto scores from different shards must
    break on the *location* the caller actually receives or the merged
    ranking would depend on shard layout.  Implemented as three stable
    argsorts (offset, then file_id, then ``-score``) == one lexsort with
    score majorizing.  Pad slots (score ``-1``) sort last under ``-score``
    regardless of their location columns.  Used by both
    :meth:`IndexStore.similar_batch` (merging shards) and the router
    (merging replica scatter results) so the two paths cannot drift.
    Host numpy, as in the reference: the parts are ``(Q, k)`` each.
    """
    scores = np.concatenate([p[0] for p in parts], axis=1)
    fids = np.concatenate([p[1] for p in parts], axis=1)
    offs = np.concatenate([p[2] for p in parts], axis=1)

    def take(order):
        return (
            np.take_along_axis(scores, order, axis=1),
            np.take_along_axis(fids, order, axis=1),
            np.take_along_axis(offs, order, axis=1),
        )

    scores, fids, offs = take(np.argsort(offs, axis=1, kind="stable"))
    scores, fids, offs = take(np.argsort(fids, axis=1, kind="stable"))
    scores, fids, offs = take(
        np.argsort(-scores, axis=1, kind="stable")[:, :k]
    )
    pad = scores < 0.0
    return (
        np.where(pad, np.float32(-1.0), scores).astype(np.float32, copy=False),
        np.where(pad, np.int32(-1), fids).astype(np.int32, copy=False),
        np.where(pad, np.int64(-1), offs).astype(np.int64, copy=False),
    )


# ---------------------------------------------------------------------------
# Persistence: ByteOffsetIndex -> sharded store directory
# ---------------------------------------------------------------------------

def _shard_stem(s: int) -> str:
    return f"shard_{s:04d}"


def _atomic_save(path: Path, arr: np.ndarray) -> None:
    """np.save via temp file + rename: a live reader mmap-ing ``path`` keeps
    its old inode intact instead of seeing a truncated/torn rewrite."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def save_sharded(
    index,
    root: Path,
    n_shards: int = 16,
    digest_bits: int = 64,
    bloom_bits_per_key: int = 12,
    fingerprint_bits: Optional[int] = DEFAULT_FP_BITS,
) -> Dict[str, object]:
    """Partition ``index.entries`` into digest-range shards under ``root``.

    Each shard gets sorted-digest data columns, a Bloom sidecar, a packed
    fingerprint plane (``fingerprint_bits`` wide; ``None`` disables the
    similarity modality), and a content hash in the manifest.  When ``root``
    already holds a store built with the same parameters, shards whose
    content hash is unchanged are *not* rewritten — an incremental
    :func:`repro_torch.core.index.update_index` followed by ``save_sharded``
    republishes only the shards it touched.  Fingerprints are a pure
    function of the key text, so an unchanged content hash (which covers
    the keys column) implies an unchanged fingerprint plane.

    Only primary entries are written (shadowed duplicate-key locations stay
    in the CSV truth, exactly like ``save_binary``).  Returns a summary:
    ``{"written", "skipped", "n_entries", "path"}``.
    """
    if n_shards < 1 or (n_shards & (n_shards - 1)):
        raise ValueError(f"n_shards must be a power of two, got {n_shards}")
    if fingerprint_bits is not None:
        words_for(fingerprint_bits)  # validate width up front
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)

    keys: List[str] = list(index.entries.keys())
    locs = [index.entries[k] for k in keys]
    file_names = sorted({f for f, _ in locs})
    file_id_of = {n: i for i, n in enumerate(file_names)}

    digests = digest_u64(keys, bits=digest_bits)
    sid = shard_of(digests, n_shards, digest_bits)

    # previous manifest (same params) enables the skip-unchanged fast path
    old_shards: Optional[List[dict]] = None
    mpath = root / MANIFEST_NAME
    if mpath.exists():
        try:
            old = json.loads(mpath.read_text())
        except (OSError, json.JSONDecodeError):
            old = None
        if (
            old
            and old.get("version") == FORMAT_VERSION
            and old.get("n_shards") == n_shards
            and old.get("digest_bits") == digest_bits
            # the shard content hash covers only the data columns, so the
            # Bloom sizing must match too or a skipped shard would keep its
            # old bitmap under a new manifest bloom_k (false negatives)
            and old.get("bloom_bits_per_key") == bloom_bits_per_key
            # the fingerprint plane is derived from the hashed keys column,
            # so hash-equality extends to it only at the same bit width
            and old.get("fingerprint_bits") == fingerprint_bits
            and old.get("file_names") == file_names
            and len(old.get("shards", ())) == n_shards
        ):
            old_shards = old["shards"]

    shards_meta: List[dict] = []
    written = skipped = 0
    for s in range(n_shards):
        members = np.nonzero(sid == s)[0]
        d = digests[members]
        order = np.argsort(d, kind="stable")
        members = members[order]
        d = d[order]
        fid = np.array([file_id_of[locs[i][0]] for i in members], dtype=np.int32)
        off = np.array([locs[i][1] for i in members], dtype=np.int64)
        if len(members):
            kb = np.array([keys[i].encode() for i in members], dtype=np.bytes_)
        else:
            kb = np.array([], dtype="S1")

        h = hashlib.blake2b(digest_size=16)
        for col in (d, fid, off, kb):
            h.update(col.tobytes())
        content = h.hexdigest()
        # bloom_k is deterministic in (count, bits_per_key): record it
        # without building a bitmap so skipped shards cost nothing
        _, bloom_k = BloomFilter.plan(len(d), bloom_bits_per_key)
        meta = {"count": int(len(d)), "hash": content, "bloom_k": bloom_k}

        stem = _shard_stem(s)
        paths = {c: root / f"{stem}.{c}.npy" for c in _COLUMNS}
        bloom_path = root / f"{stem}.bloom.npy"
        fp_paths = (root / f"{stem}.fps.npy", root / f"{stem}.fpcounts.npy")
        unchanged = (
            old_shards is not None
            and old_shards[s].get("hash") == content
            and all(p.exists() for p in paths.values())
            and bloom_path.exists()
            and (
                fingerprint_bits is None
                or all(p.exists() for p in fp_paths)
            )
        )
        if unchanged:
            skipped += 1
        else:
            _atomic_save(paths["digests"], d)
            _atomic_save(paths["file_ids"], fid)
            _atomic_save(paths["offsets"], off)
            _atomic_save(paths["keys"], kb)
            _atomic_save(
                bloom_path,
                BloomFilter.build(d, bits_per_key=bloom_bits_per_key).bits,
            )
            if fingerprint_bits is not None:
                fps, fpc = fingerprint_batch(
                    [keys[i] for i in members], fingerprint_bits
                )
                _atomic_save(fp_paths[0], fps)
                _atomic_save(fp_paths[1], fpc)
            written += 1
        shards_meta.append(meta)

    manifest = {
        "version": FORMAT_VERSION,
        "key_mode": getattr(index, "key_mode", "full_id"),
        "n_shards": n_shards,
        "digest_bits": digest_bits,
        "bloom_bits_per_key": bloom_bits_per_key,
        "fingerprint_bits": fingerprint_bits,
        "n_entries": len(keys),
        "file_names": file_names,
        "shards": shards_meta,
    }
    tmp = mpath.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(manifest, indent=1))
    os.replace(tmp, mpath)  # atomic publish
    # drop shard files a previous layout left behind (republish with fewer
    # shards, crashed temp files) — unreachable through the new manifest
    # but they would inflate the on-disk footprint forever
    sidecars = (*_COLUMNS, "bloom") + (
        ("fps", "fpcounts") if fingerprint_bits is not None else ()
    )
    expected = {
        f"{_shard_stem(s)}.{c}.npy"
        for s in range(n_shards)
        for c in sidecars
    }
    for p in root.glob("shard_*"):
        if p.name not in expected:
            p.unlink()
    return {
        "written": written,
        "skipped": skipped,
        "n_entries": len(keys),
        "path": str(root),
    }


# ---------------------------------------------------------------------------
# The query service
# ---------------------------------------------------------------------------

@dataclass
class QueryStats:
    """Cumulative counters across ``lookup_batch`` calls."""

    queries: int = 0
    hits: int = 0
    bloom_rejects: int = 0          # dropped before touching any data column
    bloom_false_positives: int = 0  # passed the filter, no digest in shard
    digest_probes: int = 0          # candidates probed against a digest column
    verify_collisions: int = 0      # equal digest, different key (scanned past)
    similar_queries: int = 0        # fingerprint rows submitted to similar_batch
    fp_rows_scanned: int = 0        # query x database row pairs Tanimoto-scored
    shards_touched: Set[int] = field(default_factory=set)

    def merge(self, other: "QueryStats") -> None:
        """Fold ``other`` in (router replica aggregation, stats flushes)."""
        self.queries += other.queries
        self.hits += other.hits
        self.bloom_rejects += other.bloom_rejects
        self.bloom_false_positives += other.bloom_false_positives
        self.digest_probes += other.digest_probes
        self.verify_collisions += other.verify_collisions
        self.similar_queries += other.similar_queries
        self.fp_rows_scanned += other.fp_rows_scanned
        self.shards_touched |= other.shards_touched


class _Shard:
    __slots__ = ("digests", "file_ids", "offsets", "keys")

    def __init__(self, digests, file_ids, offsets, keys):
        self.digests = digests
        self.file_ids = file_ids
        self.offsets = offsets
        self.keys = keys

    @property
    def nbytes(self) -> int:
        return sum(
            int(a.nbytes) for a in (self.digests, self.file_ids, self.offsets, self.keys)
        )


class IndexStore:
    """mmap-backed sharded index with Bloom prefilter and batched lookups.

    Drop-in for the read side of :class:`ByteOffsetIndex` (``lookup`` /
    ``locate_batch`` / ``key_mode`` / ``__contains__``), so
    :func:`repro_torch.core.extract.extract` and the training data pipeline run
    unchanged on top of it — but the core API is :meth:`lookup_batch`, which
    amortizes digesting, routing, filtering, and probing across the whole
    batch.

    ``device`` (default ``"cuda"``) is where the digest probe and the
    Tanimoto scan run: each touched shard's digest column, and its
    fingerprint plane with its counts, are uploaded there once, at first
    device use, and ``probe="auto"`` means ``"device"`` on a CUDA store.
    Asking for ``"cuda"`` without CUDA raises; ``device="cpu"`` keeps the
    device tables on the host, where the probe and the scan run the
    kernels' plain PyTorch versions.
    """

    def __init__(
        self,
        root: Path,
        manifest: dict,
        mmap: bool = True,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.root = Path(root)
        self.manifest = manifest
        self.key_mode: str = manifest["key_mode"]
        self.n_shards: int = int(manifest["n_shards"])
        self.digest_bits: int = int(manifest["digest_bits"])
        self.file_names: List[str] = list(manifest["file_names"])
        # None on stores published before the similarity modality (or with
        # fingerprints disabled): similar_batch raises a clear error then
        fp_bits = manifest.get("fingerprint_bits")
        self.fingerprint_bits: Optional[int] = (
            int(fp_bits) if fp_bits is not None else None
        )
        self._mmap = bool(mmap)
        self._shards: Dict[int, _Shard] = {}
        self._blooms: Dict[int, BloomFilter] = {}
        self._fp_shards: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # Per-shard tables on self.device, the device counterpart of the
        # lazy mmap, each uploaded once at first device use: (M, 2) uint32
        # digest tables with their route and fences (ProbeTable) and
        # ((N, W) uint32, (N,) int32) fingerprint planes.  Replicas of one
        # store share them (share_device_tables); the owner alone counts
        # them in resident_bytes.
        self._probe_tables: Dict[int, ProbeTable] = {}
        self._fp_tables: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._table_lock = threading.Lock()
        self._owns_tables = True
        self.stats = QueryStats()
        # Concurrent lookup_batch callers (the service's scatter-gather
        # workers) race the lazy first-touch np.load of a shard and the
        # shared stats counters; both are serialized here.  Loads hold the
        # lock only around the miss path, so warm probes stay lock-free on
        # the dict read (GIL-atomic) and pay one uncontended acquire per
        # stats flush.
        self._load_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        # Cross-shard Bloom plane (lazy): every shard's bitmap concatenated
        # so a multi-shard batch runs ONE vectorized filter pass instead of
        # a per-shard pass whose fixed numpy dispatch cost dominates
        # micro-batches.  Bitmaps are the small always-cheap part of the
        # store (~bits_per_key/8 bytes per entry), so pinning them all is
        # the designed serving posture; data columns stay mmap-lazy.
        self._bloom_plane: Optional[Tuple[np.ndarray, ...]] = None
        # Serving plane (opt-in via preload_digest_plane): digest, file_id
        # and offset columns concatenated in shard order — digest-range
        # partitioning makes the digest concatenation one globally sorted
        # array, so a whole batch probes with ONE searchsorted and gathers
        # its hit locations with vectorized fancy-indexing instead of a
        # per-shard loop of scalar mmap reads.  Costs 20 resident
        # bytes/entry (the fat keys column stays mmap-lazy), which is why
        # it is the serving posture (the ShardRouter turns it on), not the
        # default.
        self._digest_plane: Optional[Tuple[np.ndarray, ...]] = None
        # The serving plane's digests as one (M, 2) uint32 table on
        # self.device, with its route and fences: a device probe of a whole
        # batch is then ONE launch.
        self._probe_plane: Optional[ProbeTable] = None
        self._owns_probe_plane = False  # False when adopted from a replica

    @classmethod
    def open(
        cls, root: Path, mmap: bool = True, device: DeviceLike = "cuda"
    ) -> "IndexStore":
        root = Path(root)
        manifest = json.loads((root / MANIFEST_NAME).read_text())
        if manifest.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported store version {manifest.get('version')!r} "
                f"(expected {FORMAT_VERSION})"
            )
        return cls(root, manifest, mmap=mmap, device=device)

    # -- lazy shard access ---------------------------------------------------

    def _load_column(self, stem: str, col: str, count: int) -> np.ndarray:
        path = self.root / f"{stem}.{col}.npy"
        if count == 0:
            # np.memmap refuses zero-length maps; synthesize the empty column
            empty_dtype = {"digests": np.uint64, "file_ids": np.int32,
                           "offsets": np.int64, "keys": "S1"}[col]
            return np.array([], dtype=empty_dtype)
        return np.load(path, mmap_mode="r" if self._mmap else None)

    def _shard(self, s: int) -> _Shard:
        shard = self._shards.get(s)
        if shard is None:
            with self._load_lock:  # double-checked: losers reuse the winner's
                shard = self._shards.get(s)
                if shard is None:
                    stem = _shard_stem(s)
                    count = int(self.manifest["shards"][s]["count"])
                    shard = _Shard(
                        *(self._load_column(stem, c, count) for c in _COLUMNS)
                    )
                    self._shards[s] = shard
        return shard

    def _probe_table(self, s: int) -> ProbeTable:
        """Shard ``s``'s digest column as an ``(M, 2)`` uint32 ``(hi, lo)``
        table on the store's device, with its route and fences (uploaded
        and built once, at first use)."""
        table = self._probe_tables.get(s)
        if table is None:
            digests = self._shard(s).digests  # takes _load_lock itself
            with self._table_lock:
                table = self._probe_tables.get(s)
                if table is None:
                    table = ProbeTable(_pairs_tensor(digests, self.device))
                    self._probe_tables[s] = table
        return table

    def _fp_table(self, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard ``s``'s fingerprint plane ``(N, W)`` uint32 and counts
        ``(N,)`` int32 on the store's device (uploaded once, at first
        use)."""
        pair = self._fp_tables.get(s)
        if pair is None:
            fps, counts = self._fp_shard(s)  # takes _load_lock itself
            with self._table_lock:
                pair = self._fp_tables.get(s)
                if pair is None:
                    pair = (
                        _host_tensor(fps).to(self.device),
                        _host_tensor(counts).to(self.device),
                    )
                    self._fp_tables[s] = pair
        return pair

    def share_device_tables(self, owner: "IndexStore") -> None:
        """Use ``owner``'s per-shard device tables (digest and fingerprint)
        instead of uploading copies: replicas of one store on one device
        then hold each shard's tables once, counted by ``owner``."""
        if owner.device != self.device or owner.root != self.root:
            raise ValueError("only replicas of one store on one device share")
        with self._table_lock:
            self._probe_tables = owner._probe_tables
            self._fp_tables = owner._fp_tables
            self._table_lock = owner._table_lock
            self._owns_tables = False

    def _fp_shard(self, s: int) -> Tuple[np.ndarray, np.ndarray]:
        """Lazy mmap of shard ``s``'s ``(fps, fpcounts)`` fingerprint plane."""
        pair = self._fp_shards.get(s)
        if pair is None:
            if self.fingerprint_bits is None:
                raise ValueError(
                    "store has no fingerprint plane (published with "
                    "fingerprint_bits=None or by a writer older than similarity); "
                    "re-run save_sharded with fingerprint_bits set"
                )
            with self._load_lock:
                pair = self._fp_shards.get(s)
                if pair is None:
                    count = int(self.manifest["shards"][s]["count"])
                    w = words_for(self.fingerprint_bits)
                    if count == 0:
                        pair = (
                            np.zeros((0, w), dtype=np.uint32),
                            np.zeros(0, dtype=np.int32),
                        )
                    else:
                        stem = _shard_stem(s)
                        mode = "r" if self._mmap else None
                        pair = (
                            np.load(self.root / f"{stem}.fps.npy",
                                    mmap_mode=mode),
                            np.load(self.root / f"{stem}.fpcounts.npy",
                                    mmap_mode=mode),
                        )
                    self._fp_shards[s] = pair
        return pair

    def _bloom(self, s: int) -> BloomFilter:
        bloom = self._blooms.get(s)
        if bloom is None:
            with self._load_lock:
                bloom = self._blooms.get(s)
                if bloom is None:
                    bits = np.load(self.root / f"{_shard_stem(s)}.bloom.npy")
                    bloom = BloomFilter(np.asarray(bits, dtype=np.uint8),
                                        int(self.manifest["shards"][s]["bloom_k"]))
                    self._blooms[s] = bloom
        return bloom

    def _bloom_filter_plane(self) -> Tuple[np.ndarray, ...]:
        """``(bits_concat, byte_off, m_mask, k)`` across all shards."""
        plane = self._bloom_plane
        if plane is None:
            with self._load_lock:
                plane = self._bloom_plane
            if plane is not None:
                return plane
            blooms = [self._bloom(s) for s in range(self.n_shards)]
            bits = np.concatenate([b.bits for b in blooms])
            off = np.zeros(self.n_shards, dtype=np.int64)
            np.cumsum([b.bits.shape[0] for b in blooms[:-1]], out=off[1:])
            m_mask = np.array([b.m - 1 for b in blooms], dtype=np.uint64)
            k = np.array([b.k for b in blooms], dtype=np.int64)
            plane = (bits, off, m_mask, k)
            with self._load_lock:
                self._bloom_plane = plane
        return plane

    def preload_digest_plane(self) -> Tuple:
        """Pin the serving plane + Bloom plane (serving mode).

        The serving plane is ``(digests, row_off, file_ids, offsets)``
        concatenated across shards — 20 resident bytes/entry.  The fat
        keys column (the verify column) stays mmap-lazy; only verified
        hits fault its pages in.  The plane's digests are also pinned on
        the store's device as one ``(M, 2)`` uint32 table with its fences
        (a ``ProbeTable``), so a device probe of a whole batch is one
        kernel launch.  Returns
        ``(serving_plane, bloom_plane, probe_plane)`` so replicas of the
        same store can share the (read-only) planes instead of re-building.
        """
        if self._digest_plane is None:
            counts = [int(m["count"]) for m in self.manifest["shards"]]
            row_off = np.zeros(self.n_shards + 1, dtype=np.int64)
            np.cumsum(counts, out=row_off[1:])
            shards = [self._shard(s) for s in range(self.n_shards)]

            def concat(arrs, dtype):
                return (
                    np.concatenate([np.asarray(a) for a in arrs])
                    if arrs
                    else np.empty(0, dtype=dtype)
                )

            d_all = concat([sh.digests for sh in shards], np.uint64)
            f_all = concat([sh.file_ids for sh in shards], np.int32)
            o_all = concat([sh.offsets for sh in shards], np.int64)
            table = ProbeTable(_pairs_tensor(d_all, self.device))
            with self._load_lock:
                self._digest_plane = (d_all, row_off, f_all, o_all)
                self._probe_plane = table
                self._owns_probe_plane = True
        return self._digest_plane, self._bloom_filter_plane(), self._probe_plane

    def adopt_planes(self, planes: Tuple) -> None:
        """Share another replica's (immutable) preloaded planes.

        The device table and its fences are shared too when they already
        lie on this store's device; only then are they counted by their
        owner alone.  Otherwise both are copied here (the fences are not
        built again).
        """
        digest_plane, bloom_plane, table = planes
        owned = table.device != self.device
        if owned:
            table = table.to(self.device)
        with self._load_lock:
            self._digest_plane = digest_plane
            self._bloom_plane = bloom_plane
            self._probe_plane = table
            self._owns_probe_plane = owned

    def _bloom_pass(self, q: np.ndarray, sid: np.ndarray) -> np.ndarray:
        """One vectorized Bloom probe for a whole (multi-shard) batch.

        Identical accept/reject decisions to probing each shard's filter
        separately — same double-hash positions against the same bitmaps,
        gathered through the concatenated plane — but one numpy pass
        total, so a batch spread thinly over many shards (the continuous
        micro-batching regime) no longer pays per-shard dispatch overhead.
        """
        from .bloom import _mix64

        bits, off, m_mask, k = self._bloom_filter_plane()
        kmax = int(k.max()) if len(k) else 1
        h2 = _mix64(q) | np.uint64(1)
        i = np.arange(kmax, dtype=np.uint64)[:, None]
        pos = (q[None, :] + i * h2[None, :]) & m_mask[sid][None, :]
        byte = bits[(pos >> np.uint64(3)).astype(np.int64) + off[sid][None, :]]
        bit = (byte >> (pos & np.uint64(7)).astype(np.uint8)) & np.uint8(1)
        # rows past a shard's own k are neutral (True) under the AND
        valid = np.arange(kmax, dtype=np.int64)[:, None] < k[sid][None, :]
        return np.where(valid, bit.astype(bool), True).all(axis=0)

    # -- core batched query --------------------------------------------------

    def lookup_batch(
        self,
        keys: Sequence[str],
        probe: Optional[str] = None,
        digests: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Resolve a batch of keys: ``(file_ids, offsets, hit_mask)``.

        ``file_ids`` (int32) index :attr:`file_names`; misses hold ``-1`` in
        both columns and ``False`` in ``hit_mask``.  ``probe`` selects the
        digest-search backend: ``"host"`` (``np.searchsorted``), ``"device"``
        (``sorted_probe`` on the store's device: the CUDA kernel on a CUDA
        store, its plain PyTorch version on a CPU store), or
        ``None``/"auto" (``"device"`` on a CUDA store, else ``"host"``).

        ``digests`` (optional uint64, parallel to ``keys``) skips the
        per-call ``digest_u64`` — the service's router digests a request
        batch ONCE and hands each shard probe its slice.  Thread-safe:
        concurrent callers may share one store (lazy shard loads and stats
        flushes are serialized internally).
        """
        n = len(keys)
        file_ids = np.full(n, -1, dtype=np.int32)
        offsets = np.full(n, -1, dtype=np.int64)
        hit = np.zeros(n, dtype=bool)
        if n == 0:
            return file_ids, offsets, hit
        if probe is None or probe == "auto":
            probe = "device" if self.device.type == "cuda" else "host"
        if probe not in ("host", "device"):
            raise ValueError(f"unknown probe backend {probe!r}")

        if digests is None:
            q = digest_u64(keys, bits=self.digest_bits)
        else:
            q = np.asarray(digests, dtype=np.uint64)
            if q.shape != (n,):
                raise ValueError(
                    f"digests shape {q.shape} does not match {n} keys"
                )
        sid = shard_of(q, self.n_shards, self.digest_bits)
        delta = QueryStats(queries=n)

        if self._digest_plane is not None:
            # serving posture: one global probe over the pinned digest plane
            self._lookup_plane(keys, q, sid, file_ids, offsets, hit, delta,
                               probe)
            delta.hits = int(hit.sum())
            with self._stats_lock:
                self.stats.merge(delta)
            return file_ids, offsets, hit

        # one stable argsort groups the batch by shard (contiguous slices);
        # per-shard nonzero scans would cost O(S * n) numpy dispatches
        order = np.argsort(sid, kind="stable")
        uniq, group_starts = np.unique(sid[order], return_index=True)
        # a multi-shard batch takes one cross-shard Bloom pass when the
        # serving posture already pinned the plane (it covers ALL shards,
        # so building it here would force every bitmap resident on a
        # store that promised O(touched shards)); otherwise each touched
        # shard probes its own lazily-loaded filter
        passed_all = (
            self._bloom_pass(q, sid)
            if len(uniq) > 1 and self._bloom_plane is not None
            else None
        )

        for gi in range(len(uniq)):
            s = int(uniq[gi])
            lo = group_starts[gi]
            hi = group_starts[gi + 1] if gi + 1 < len(uniq) else n
            sel = order[lo:hi]
            if passed_all is not None:
                passed = passed_all[sel]
            else:
                passed = self._bloom(s).contains(q[sel])
            delta.bloom_rejects += int(len(sel) - passed.sum())
            sel = sel[passed]
            if not len(sel):
                continue
            shard = self._shard(s)
            delta.shards_touched.add(s)
            qd = q[sel]
            td = shard.digests
            delta.digest_probes += int(len(sel))
            if probe == "device":
                found, starts = _probe_starts_device(self._probe_table(s), qd)
            else:
                starts = np.searchsorted(td, qd, side="left")
                inb = starts < len(td)
                found = np.zeros(len(qd), dtype=bool)
                found[inb] = td[starts[inb]] == qd[inb]
            delta.bloom_false_positives += int((~found).sum())
            for j in np.nonzero(found)[0]:
                row = int(sel[j])
                kb = keys[row].encode()
                t = int(starts[j])
                while t < len(td) and td[t] == qd[j]:
                    if shard.keys[t] == kb:
                        file_ids[row] = shard.file_ids[t]
                        offsets[row] = shard.offsets[t]
                        hit[row] = True
                        break
                    delta.verify_collisions += 1  # digest collision
                    t += 1

        delta.hits = int(hit.sum())
        with self._stats_lock:
            self.stats.merge(delta)
        return file_ids, offsets, hit

    def _lookup_plane(
        self,
        keys: Sequence[str],
        q: np.ndarray,
        sid: np.ndarray,
        file_ids: np.ndarray,
        offsets: np.ndarray,
        hit: np.ndarray,
        delta: "QueryStats",
        probe: str,
    ) -> None:
        """Batch probe against the pinned serving plane.

        Identical results to the per-shard loop: same Bloom decisions,
        same leftmost-of-run starts (the plane is the shard columns
        concatenated in shard order, globally sorted), same full-key
        verify discipline.  The verify itself is vectorized: candidate
        key bytes gather through ONE fancy-index per touched shard and
        compare in bulk; only candidates that fail that first compare
        (digest collisions — rare by construction) fall back to the
        scalar run scan.  Equal digests share top bits, so a run never
        crosses a shard boundary.  ``probe="device"`` searches the plane's
        device table with ``sorted_probe`` instead of ``np.searchsorted``.
        """
        d_all, row_off, f_all, o_all = self._digest_plane
        passed = self._bloom_pass(q, sid)
        delta.bloom_rejects += int(len(q) - passed.sum())
        sel = np.nonzero(passed)[0]
        if not len(sel):
            return
        delta.digest_probes += int(len(sel))
        # same "touched" accounting as the per-shard loop: every shard
        # with a Bloom-passing key counts, found or not (physically the
        # plane answers non-hits without faulting shard columns, but the
        # stats contract mirrors the loop so the paths stay comparable)
        delta.shards_touched.update(
            int(s) for s in np.unique(sid[sel])
        )
        qd = q[sel]
        if probe == "device":
            found, starts = _probe_starts_device(self._probe_plane, qd)
        else:
            starts = np.searchsorted(d_all, qd, side="left")
            inb = starts < len(d_all)
            found = np.zeros(len(sel), dtype=bool)
            found[inb] = d_all[starts[inb]] == qd[inb]
        delta.bloom_false_positives += int((~found).sum())
        fj = np.nonzero(found)[0]
        if not len(fj):
            return
        frow = sel[fj]                  # batch rows with a digest hit
        fpos = starts[fj]               # global plane positions (run heads)
        fshard = (
            np.searchsorted(row_off, fpos, side="right") - 1
        ).astype(np.int64)
        expected = np.array([keys[r].encode() for r in frow], dtype=np.bytes_)
        ok = np.zeros(len(fj), dtype=bool)
        for s in np.unique(fshard):
            s = int(s)
            g = np.nonzero(fshard == s)[0]
            cand = self._shard(s).keys[fpos[g] - row_off[s]]  # one gather
            ok[g] = cand == expected[g]
        hrows = frow[ok]
        file_ids[hrows] = f_all[fpos[ok]]
        offsets[hrows] = o_all[fpos[ok]]
        hit[hrows] = True
        # First candidate mismatched: walk the equal-digest run (the
        # Algorithm 3 collision discipline, scalar because it is rare).
        for j in np.nonzero(~ok)[0]:
            row = int(frow[j])
            s = int(fshard[j])
            shard = self._shard(s)
            base = int(row_off[s])
            end = int(row_off[s + 1])
            kb = expected[j]
            qdj = q[row]
            t = int(fpos[j])
            while t < end and d_all[t] == qdj:
                if shard.keys[t - base] == kb:
                    file_ids[row] = f_all[t]
                    offsets[row] = o_all[t]
                    hit[row] = True
                    break
                delta.verify_collisions += 1  # digest collision
                t += 1

    # -- similarity modality ---------------------------------------------------

    def fp_words(self) -> int:
        """uint32 words per fingerprint row (raises without a plane)."""
        if self.fingerprint_bits is None:
            raise ValueError("store has no fingerprint plane")
        return words_for(self.fingerprint_bits)

    def _check_fps(self, fps: np.ndarray) -> np.ndarray:
        fps = np.ascontiguousarray(fps, dtype=np.uint32)
        if fps.ndim == 1:
            fps = fps[None, :]
        if fps.ndim != 2 or fps.shape[1] != self.fp_words():
            raise ValueError(
                f"query fingerprints must be (Q, {self.fp_words()}) uint32 "
                f"(fingerprint_bits={self.fingerprint_bits}), got {fps.shape}"
            )
        return fps

    def _similar_probe(self, probe: Optional[str]) -> str:
        if probe is None or probe == "auto":
            return "device" if self.device.type == "cuda" else "host"
        if probe not in ("host", "device"):
            raise ValueError(f"unknown probe backend {probe!r}")
        return probe

    def _query_tensors(
        self, fps: np.ndarray, q_counts: np.ndarray
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A query batch and its counts on the store's device (uploaded once
        per batch, shared by every shard it scans)."""
        return (
            torch.from_numpy(fps).to(self.device),
            torch.from_numpy(np.ascontiguousarray(q_counts, dtype=np.int32))
            .to(self.device),
        )

    def _similar_shard(
        self,
        s: int,
        fps: np.ndarray,
        k: int,
        probe: str,
        q_counts: np.ndarray,
        delta: QueryStats,
        queries: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k of one shard's plane, rows mapped to ``(file_id, offset)``.

        Within a shard ties break by row index (ascending digest order) —
        the kernel/reference contract — which the cross-shard merge then
        re-breaks on ``(file_id, offset)``; see :func:`merge_similar_topk`.
        ``probe="device"`` scans the shard's plane on the store's device
        with ``tanimoto_topk`` (the CUDA kernel on a CUDA store, its plain
        version on a CPU store; ``queries`` is the batch already there);
        ``"host"`` runs the cache-blocked ``tanimoto_topk_host`` on the CPU
        over the mmap'd plane, as the reference does.
        """
        qn = fps.shape[0]
        count = int(self.manifest["shards"][s]["count"])
        if count == 0:
            return (
                np.full((qn, k), -1.0, dtype=np.float32),
                np.full((qn, k), -1, dtype=np.int32),
                np.full((qn, k), -1, dtype=np.int64),
            )
        delta.shards_touched.add(s)
        delta.fp_rows_scanned += count * qn
        if probe == "device":
            db, dc = self._fp_table(s)
            q, qc = queries or self._query_tensors(fps, q_counts)
            scores, rows = tanimoto_topk(q, db, k, q_counts=qc, db_counts=dc)
            scores, rows = scores.cpu().numpy(), rows.cpu().numpy()
        else:
            db, dc = self._fp_shard(s)
            scores, rows = tanimoto_topk_host(fps, db, k, q_counts=q_counts,
                                              db_counts=dc)
        shard = self._shard(s)
        valid = rows >= 0
        r = np.where(valid, rows, 0)
        fids = np.where(
            valid, np.asarray(shard.file_ids)[r], np.int32(-1)
        ).astype(np.int32, copy=False)
        offs = np.where(
            valid, np.asarray(shard.offsets)[r], np.int64(-1)
        ).astype(np.int64, copy=False)
        return scores, fids, offs

    def similar_shard(
        self,
        s: int,
        fps: np.ndarray,
        k: int,
        probe: Optional[str] = None,
        q_counts: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One shard's ``(scores, file_ids, offsets)`` top-k (router scatter)."""
        fps = self._check_fps(fps)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        if not 0 <= s < self.n_shards:
            raise ValueError(f"shard {s} out of range [0, {self.n_shards})")
        qc = (
            popcount_u32(fps).sum(axis=1, dtype=np.int32)
            if q_counts is None else np.asarray(q_counts, dtype=np.int32)
        )
        delta = QueryStats()
        out = self._similar_shard(
            s, fps, k, self._similar_probe(probe), qc, delta
        )
        with self._stats_lock:
            self.stats.merge(delta)
        return out

    def similar_batch(
        self,
        fps: np.ndarray,
        k: int,
        probe: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched Tanimoto top-k over every shard's fingerprint plane.

        ``fps`` is ``(Q, W)`` uint32 (one packed query fingerprint per
        row, e.g. :func:`repro_torch.core.fingerprint.fold_fingerprint`
        output); returns ``(scores (Q, k) float32, file_ids (Q, k) int32,
        offsets (Q, k) int64)`` ordered by ``(score desc, file_id asc,
        offset asc)``, padded with ``-1`` columns when the corpus holds
        fewer than ``k`` rows.  ``probe`` selects the scoring backend like
        :meth:`lookup_batch`: ``"device"`` (``tanimoto_topk`` on the
        store's device), ``"host"`` (``tanimoto_topk_host`` on the CPU —
        byte-identical), or ``None``/"auto" (``"device"`` on a CUDA
        store, else ``"host"``).  Thread-safe like ``lookup_batch``.
        """
        fps = self._check_fps(fps)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        probe = self._similar_probe(probe)
        qn = fps.shape[0]
        delta = QueryStats(similar_queries=qn)
        if qn == 0:
            with self._stats_lock:
                self.stats.merge(delta)
            e = np.zeros((0, k))
            return (
                e.astype(np.float32),
                e.astype(np.int32),
                e.astype(np.int64),
            )
        qc = popcount_u32(fps).sum(axis=1, dtype=np.int32)
        queries = (
            self._query_tensors(fps, qc) if probe == "device" else None
        )
        parts = [
            self._similar_shard(s, fps, k, probe, qc, delta, queries)
            for s in range(self.n_shards)
            if int(self.manifest["shards"][s]["count"]) > 0
        ]
        if not parts:
            out = (
                np.full((qn, k), -1.0, dtype=np.float32),
                np.full((qn, k), -1, dtype=np.int32),
                np.full((qn, k), -1, dtype=np.int64),
            )
        else:
            out = merge_similar_topk(parts, k)
        with self._stats_lock:
            self.stats.merge(delta)
        return out

    # -- ByteOffsetIndex-compatible read surface -------------------------------

    def locate_batch(
        self, keys: Sequence[str], probe: Optional[str] = None
    ) -> List[Optional[Tuple[str, int]]]:
        """String-level convenience over :meth:`lookup_batch`."""
        fid, off, hit = self.lookup_batch(keys, probe=probe)
        return [
            (self.file_names[fid[i]], int(off[i])) if hit[i] else None
            for i in range(len(keys))
        ]

    def lookup(self, key: str) -> Optional[Tuple[str, int]]:
        return self.locate_batch([key])[0]

    def __contains__(self, key: str) -> bool:
        return self.lookup_batch([key])[2][0]

    def __len__(self) -> int:
        return int(self.manifest["n_entries"])

    def iter_keys(self) -> Iterator[str]:
        """All keys, shard by shard (loads every shard — builder-side use)."""
        for s in range(self.n_shards):
            for kb in self._shard(s).keys:
                yield kb.decode()

    # -- capacity accounting (benchmarks) -------------------------------------

    @property
    def shards_loaded(self) -> int:
        return len(self._shards)

    def total_bytes(self) -> int:
        """Persistent footprint: every store file on disk."""
        return sum(
            p.stat().st_size
            for p in self.root.iterdir()
            if p.name == MANIFEST_NAME or p.name.startswith("shard_")
        )

    def resident_bytes(self) -> int:
        """Bytes of shard columns, Bloom bitmaps and fingerprint planes
        actually faulted in, plus the tables this store put on its device,
        digest tables with their fences (tables shared with or adopted from
        a replica are counted by the replica that uploaded them).

        With mmap this is an upper bound (pages of touched shards); the
        point of comparison is against the dict index, which is *all*
        resident *always*.
        """
        dev: List[torch.Tensor] = []
        probes: List[ProbeTable] = []
        if self._owns_tables:
            probes += list(self._probe_tables.values())
            dev += [t for pair in self._fp_tables.values() for t in pair]
        if self._probe_plane is not None and self._owns_probe_plane:
            probes.append(self._probe_plane)
        return (
            sum(sh.nbytes for sh in self._shards.values())
            + sum(bf.nbytes for bf in self._blooms.values())
            + sum(
                int(fp.nbytes) + int(fc.nbytes)
                for fp, fc in self._fp_shards.values()
            )
            + sum(t.numel() * t.element_size() for t in dev)
            + sum(pt.nbytes for pt in probes)
        )


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s values (copied when ``a`` is a read-only
    mmap: torch tensors are always writable)."""
    return torch.from_numpy(np.require(a, requirements=["C", "W"]))


def _pairs_tensor(digests: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint64 digests → ``(N, 2)`` uint32 ``(hi, lo)`` tensor on ``device``."""
    return torch.from_numpy(_u64_to_pairs(np.asarray(digests))).to(device)


def _staging(n: int) -> Tuple[np.ndarray, torch.Tensor, np.ndarray, torch.Tensor]:
    """This thread's pinned host buffers, holding at least ``n`` queries:
    ``(words, pairs, results, out)``, ``words`` the first ``n`` queries'
    ``(hi, lo)`` pairs as uint64 (numpy) over the ``(cap, 2)`` uint32
    tensor ``pairs``, ``results`` the first ``5 n`` bytes (numpy) of the
    uint8 tensor ``out``.  Grown to the next power of two; one set a
    thread, because the service probes from many threads at once."""
    st = _STAGING.__dict__
    if st.get("cap", 0) < n:
        cap = 1 << max(10, (n - 1).bit_length())
        st["inp"] = torch.empty((cap, 2), dtype=torch.uint32, pin_memory=True)
        st["out"] = torch.empty(5 * cap, dtype=torch.uint8, pin_memory=True)
        st["inp_np"] = st["inp"].numpy().view(np.uint64).reshape(cap)
        st["out_np"] = st["out"].numpy()
        st["cap"] = cap
    return st["inp_np"][:n], st["inp"], st["out_np"][:5 * n], st["out"]


_STAGING = threading.local()


def _probe_starts_device(
    table: ProbeTable, query_digests: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Device digest probe: ``sorted_probe`` of the queries in ``table``.

    ``table`` is a sorted digest table already on the store's device, with
    its fences.  Returns ``(found, starts)`` with ``starts`` the leftmost
    equal-digest position — the kernel returns the global lower bound, the
    same contract as the host ``searchsorted`` path, so the equal-run
    verify loop is backend-agnostic.  On a CUDA device the digests go in
    with one copy from a pinned staging buffer and both results come out
    with one copy into another, in one call (``probe_served``).
    """
    if table.device.type != "cuda":
        found, pos = sorted_probe(
            _pairs_tensor(query_digests, table.device), table)
        return found.numpy(), pos.numpy().astype(np.int64)
    n = len(query_digests)
    inp_np, inp, out_np, out = _staging(n)
    d = np.asarray(query_digests, dtype=np.uint64)
    # a little-endian uint64 over (hi, lo) reads hi | lo << 32: the digest
    # with its halves swapped
    np.bitwise_or(d << np.uint64(32), d >> np.uint64(32), out=inp_np)
    probe_served(table, inp, out, n)
    return (out_np[4 * n:].view(np.bool_).copy(),
            out_np[:4 * n].view(np.int32).astype(np.int64))
