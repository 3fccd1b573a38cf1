"""Algorithm 3 — index-based extraction with grouped, offset-sorted seeks.

Phase 2 of the paper's architecture.  The three published optimizations
are all here and individually switchable (so the benchmarks can ablate
them, Table II / §IV.D):

1. **GroupByFilename** — one ``open()`` per file containing targets
   (477,123 potential opens → 312 in the paper).
2. **Offset-sorted traversal** — targets within a file are visited in
   ascending byte order, converting random seeks into near-sequential
   forward reads (10–100× effective-throughput on spinning disks; still
   measurable on SSD/page-cache via readahead).
3. **Defensive verification** — every extracted record's identifier is
   *recomputed from its structural data* and compared against the expected
   identifier.  This is the step that exposed the paper's InChIKey
   collisions (§VI.A): under ``hashed_key`` indexing, a collision fetches a
   structurally different molecule whose recomputed full id mismatches.

Beyond the paper, the read phase itself is pipelined
(:mod:`repro_torch.core.reader`): targets coalesce into merged spans submitted
through a pluggable I/O backend (io_uring / threaded preadv / mmap),
record boundaries come from bulk ``bytes.find`` scans over zero-copy
span buffers, files fan out over a thread pool, verification runs as
batched vectorized recomputes (:mod:`repro_torch.core.verify`), and a
:class:`~repro_torch.core.cache.RecordCache` can absorb repeat fetches.
``workers=0`` preserves the exact serial reference loop for the ablation
rows; both paths produce byte-identical ``records``/``missing``/
``mismatches``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..device import DeviceLike, resolve_device
from .cache import RecordCache
from .identifiers import hashed_key
from .reader import (
    DEFAULT_COALESCE_GAP,
    DEFAULT_SPAN_GUESS,
    DEFAULT_WORKERS,
    ReadStats,
    _recompute,
    stream_plan,
)
from .records import RecordStore, read_record_at

__all__ = [
    "ExtractionResult",
    "Mismatch",
    "assemble_plan",
    "extract",
    "extract_iter",
    "plan_extraction",
]


@dataclass(frozen=True)
class Mismatch:
    """A verification failure: what the index promised vs what the bytes say."""

    expected_id: str
    found_id: str
    file: str
    offset: int
    lookup_key: str


@dataclass
class ExtractionResult:
    records: Dict[str, str] = field(default_factory=dict)   # full_id -> record
    missing: List[str] = field(default_factory=list)        # not in index
    mismatches: List[Mismatch] = field(default_factory=list)
    files_opened: int = 0
    seeks: int = 0            # records fetched (one logical seek per target)
    bytes_read: int = 0       # bytes actually read (incl. coalescing overshoot)
    spans_read: int = 0       # pread spans issued (0 on the serial path)
    cache_hits: int = 0       # records served from the RecordCache
    plan_seconds: float = 0.0  # plan/probe phase (batched index lookups)
    read_seconds: float = 0.0  # read+verify phase (Algorithm 3's loop)
    read_backend: str = ""    # span backend the engine resolved to ("" = serial)
    inflight_peak: int = 0    # max spans in flight at once (engine path)
    verify_batches: int = 0   # physical combined verify batches
    verify_records: int = 0   # records verified through batches
    verify_batch_max: int = 0  # largest combined verify batch

    @property
    def found(self) -> int:
        return len(self.records)

    @property
    def seconds(self) -> float:
        """Total wall time (plan + read), kept for back-compatibility."""
        return self.plan_seconds + self.read_seconds


def plan_extraction(
    index,
    targets: Sequence[str],
    key_bits: int = 64,
    sort_offsets: bool = True,
) -> Tuple[Dict[str, List[Tuple[str, str, int]]], List[str]]:
    """Build the per-file extraction plan through ONE batched lookup.

    Returns ``(plan, missing)`` where ``plan[file] = [(full_id, lookup_key,
    offset), ...]`` sorted by ascending offset (if ``sort_offsets``).

    ``index`` is any read backend exposing the batch contract —
    :class:`ByteOffsetIndex` (dict), :class:`BinaryIndex` (packed sidecar),
    or :class:`repro_torch.core.store.IndexStore` (sharded mmap store, where the
    single ``locate_batch`` call amortizes digesting, Bloom filtering, and
    shard probing over the whole target list).

    Targets are always full canonical ids (the ChEMBL∩eMolecules list is
    known by full id); under ``hashed_key`` indexing the lookup key is the
    digest of the target id — exactly the paper's pipeline before the §VI.C
    migration.
    """
    hashed = getattr(index, "key_mode", "full_id") == "hashed_key"
    keys = [
        hashed_key(t, key_bits) if hashed else t for t in targets
    ]
    locate = getattr(index, "locate_batch", None)
    if locate is not None:
        locs = locate(keys)
    else:  # minimal backends: fall back to per-key lookups
        locs = [index.lookup(k) for k in keys]
    return assemble_plan(targets, keys, locs, sort_offsets)


def assemble_plan(
    targets: Sequence[str],
    keys: Sequence[str],
    locs: Sequence[Optional[Tuple[str, int]]],
    sort_offsets: bool = True,
) -> Tuple[Dict[str, List[Tuple[str, str, int]]], List[str]]:
    """Group resolved locations into the per-file extraction plan.

    Shared by :func:`plan_extraction` (direct index backends) and the
    query service's scheduler-coalesced plan path — one definition of the
    plan shape, two ways of resolving locations.
    """
    plan: Dict[str, List[Tuple[str, str, int]]] = {}
    missing: List[str] = []
    for full_id, key, loc in zip(targets, keys, locs):
        if loc is None:
            missing.append(full_id)
            continue
        fname, off = loc
        plan.setdefault(fname, []).append((full_id, key, off))
    if sort_offsets:
        for fname in plan:
            plan[fname].sort(key=lambda t: t[2])
    return plan, missing


def extract(
    store: RecordStore,
    index,  # ByteOffsetIndex | BinaryIndex | IndexStore (batch read contract)
    targets: Sequence[str],
    verify: bool = True,
    sort_offsets: bool = True,
    group_by_file: bool = True,
    key_bits: int = 64,
    workers: Optional[int] = None,
    coalesce_gap: int = DEFAULT_COALESCE_GAP,
    span_guess: int = DEFAULT_SPAN_GUESS,
    cache: Optional[RecordCache] = None,
    verify_backend: str = "auto",
    backend=None,   # SpanBackend | name | None (REPRO_READER_BACKEND)
    depth: Optional[int] = None,   # in-flight spans per worker (uring)
    verifier=None,  # shared repro_torch.core.verify.VerifyBatcher
    service=None,  # repro_torch.service.QueryService — scheduler-coalesced plan path
    device: Optional[DeviceLike] = None,
) -> ExtractionResult:
    """Algorithm 3: seek-extract every target through the index.

    ``workers`` selects the read path: ``None`` (default) uses the
    pipelined engine with :data:`~repro_torch.core.reader.DEFAULT_WORKERS`
    threads; any ``workers >= 1`` pins the engine's pool size; ``workers=0``
    runs the serial reference loop (one ``seek`` + per-line scan + per-record
    verify) — the ablation baseline the benchmarks compare against.  Both
    paths return byte-identical ``records``/``missing``/``mismatches``.

    ``coalesce_gap``/``span_guess`` tune the engine's pread coalescing and
    ``cache`` (a :class:`~repro_torch.core.cache.RecordCache`) serves repeat
    fetches without re-reading — see :mod:`repro_torch.core.reader`.

    ``service`` (a :class:`repro_torch.service.QueryService`) replaces the
    direct ``index`` probe with the service's scheduler-coalesced lookup
    path — concurrent extractions then share probe batches, the service's
    record cache (unless ``cache`` overrides it), and its long-lived read
    pool; ``index`` may be ``None``.  Output is byte-identical either way.

    The access-pattern ablations always take the serial loop, because the
    engine has no unsorted/ungrouped mode (it coalesces in offset order by
    construction): ``group_by_file=False`` is one open per target, and
    ``sort_offsets=False`` visits each file's targets in lookup order.

    ``device`` is where the engine's default verifier runs its digest
    compare: the service's device when ``service`` is given, else
    ``"cuda"``; asking for ``"cuda"`` without CUDA raises.
    """
    device = _resolve(device, service)
    t0 = time.perf_counter()
    res = ExtractionResult()
    executor = None
    if service is not None:
        plan, missing = service.plan(targets, key_bits=key_bits,
                                     sort_offsets=sort_offsets)
        if cache is None:
            cache = service.cache
        executor = service.read_executor
        if workers is None:
            workers = service.config.read_workers
        if backend is None:
            backend = service.read_backend
        if verifier is None:
            verifier = service.verifier
    else:
        plan, missing = plan_extraction(index, targets, key_bits, sort_offsets)
    res.missing = missing
    res.plan_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    found: Dict[str, str] = {}

    if workers is None:
        workers = DEFAULT_WORKERS

    if group_by_file and sort_offsets and workers > 0:
        # pipelined engine: coalesced preads, parallel file workers,
        # batched digest verification, optional record cache
        stats = ReadStats()
        for ev in stream_plan(
            store,
            plan,
            verify=verify,
            workers=workers,
            coalesce_gap=coalesce_gap,
            span_guess=span_guess,
            cache=cache,
            verify_backend=verify_backend,
            stats=stats,
            executor=executor,
            backend=backend,
            depth=depth,
            verifier=verifier,
            device=device,
        ):
            res.seeks += 1
            if ev.ok:
                found[ev.full_id] = ev.text
            else:
                res.mismatches.append(
                    Mismatch(ev.full_id, ev.found_id, ev.file, ev.offset, ev.key)
                )
        res.files_opened = stats.files_opened
        res.bytes_read = stats.bytes_read
        res.spans_read = stats.spans_read
        res.cache_hits = stats.cache_hits
        res.read_backend = stats.backend
        res.inflight_peak = stats.inflight_peak
        res.verify_batches = stats.verify_batches
        res.verify_records = stats.verify_records
        res.verify_batch_max = stats.verify_batch_max
    else:
        # serial reference paths (ablations): grouped forward seeks with the
        # per-line scan, or fully ungrouped one-open-per-target access
        def handle_record(full_id: str, key: str, fname: str, off: int, text: str):
            res.seeks += 1
            res.bytes_read += len(text)
            if verify:
                recomputed = _recompute(text)
                if recomputed != full_id:
                    # The paper's "log error" branch — and the collision signal.
                    res.mismatches.append(
                        Mismatch(full_id, recomputed, fname, off, key)
                    )
                    return
            found[full_id] = text

        if group_by_file:
            for fname, items in plan.items():
                path = store.path_of(fname)
                res.files_opened += 1
                with open(path, "rb") as handle:
                    # offsets ascend (sort_offsets) => forward-only seeks,
                    # the paper's near-sequential access pattern.
                    for full_id, key, off in items:
                        text = read_record_at(handle, off)
                        handle_record(full_id, key, fname, off, text)
        else:
            for fname, items in plan.items():
                path = store.path_of(fname)
                for full_id, key, off in items:
                    res.files_opened += 1
                    text = read_record_at(path, off)
                    handle_record(full_id, key, fname, off, text)

    # Deterministic output regardless of worker interleaving: records in
    # target order, mismatches in (file, offset) order — so the serial and
    # pipelined paths compare byte-identical.
    res.records = {t: found[t] for t in targets if t in found}
    res.mismatches.sort(key=lambda m: (m.file, m.offset, m.expected_id))
    res.read_seconds = time.perf_counter() - t1
    return res


def _resolve(device: Optional[DeviceLike], service):
    """``device``, or the service's when it is None and a service is given,
    else ``"cuda"``."""
    if device is None:
        device = service.config.device if service is not None else "cuda"
    return resolve_device(device)


def extract_iter(
    store: RecordStore,
    index,
    targets: Sequence[str],
    *,
    verify: bool = True,
    key_bits: int = 64,
    workers: Optional[int] = None,
    coalesce_gap: int = DEFAULT_COALESCE_GAP,
    span_guess: int = DEFAULT_SPAN_GUESS,
    cache: Optional[RecordCache] = None,
    verify_backend: str = "auto",
    backend=None,   # SpanBackend | name | None (REPRO_READER_BACKEND)
    depth: Optional[int] = None,
    verifier=None,  # shared repro_torch.core.verify.VerifyBatcher
    result: Optional[ExtractionResult] = None,
    service=None,  # repro_torch.service.QueryService — scheduler-coalesced plan path
    device: Optional[DeviceLike] = None,
) -> Iterator[Tuple[str, str]]:
    """Streaming Algorithm 3: yield ``(full_id, record)`` as verified.

    Records are emitted as soon as their file worker has read and verified
    them, so consumers (tokenizers, property extractors, network writers)
    overlap with reads still in flight instead of waiting for the whole
    extraction.  Yield order is completion order, not target order.

    Pass ``result`` (an :class:`ExtractionResult`) to also collect
    ``missing``/``mismatches`` and the I/O counters; its ``records`` dict
    stays empty — the stream IS the record channel.  ``workers=0`` is
    coerced to 1 (the engine is the only streaming path; use
    :func:`extract` for the serial ablation, whose access-pattern knobs —
    ``sort_offsets``/``group_by_file`` — do not apply here: the engine
    always reads each file's targets in coalesced offset order).

    ``service`` routes the plan probe through the query service's
    scheduler and defaults ``cache`` to the service's shared record cache,
    exactly as in :func:`extract`; ``index`` may then be ``None``.

    ``device`` is the default verifier's device, as in :func:`extract`.
    """
    device = _resolve(device, service)
    t0 = time.perf_counter()
    executor = None
    if service is not None:
        plan, missing = service.plan(targets, key_bits=key_bits)
        if cache is None:
            cache = service.cache
        executor = service.read_executor
        if workers is None:
            workers = service.config.read_workers
        if backend is None:
            backend = service.read_backend
        if verifier is None:
            verifier = service.verifier
    else:
        plan, missing = plan_extraction(index, targets, key_bits)
    if result is not None:
        result.missing = missing
        result.plan_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    stats = ReadStats()
    if workers is None:
        workers = DEFAULT_WORKERS
    try:
        for ev in stream_plan(
            store,
            plan,
            verify=verify,
            workers=max(1, workers),
            coalesce_gap=coalesce_gap,
            span_guess=span_guess,
            cache=cache,
            verify_backend=verify_backend,
            stats=stats,
            executor=executor,
            backend=backend,
            depth=depth,
            verifier=verifier,
            device=device,
        ):
            if result is not None:
                result.seeks += 1
            if ev.ok:
                yield ev.full_id, ev.text
            elif result is not None:
                result.mismatches.append(
                    Mismatch(ev.full_id, ev.found_id, ev.file, ev.offset, ev.key)
                )
    finally:
        if result is not None:
            result.files_opened += stats.files_opened
            result.bytes_read += stats.bytes_read
            result.spans_read += stats.spans_read
            result.cache_hits += stats.cache_hits
            result.read_backend = result.read_backend or stats.backend
            result.inflight_peak = max(result.inflight_peak, stats.inflight_peak)
            result.verify_batches += stats.verify_batches
            result.verify_records += stats.verify_records
            result.verify_batch_max = max(
                result.verify_batch_max, stats.verify_batch_max
            )
            result.mismatches.sort(key=lambda m: (m.file, m.offset, m.expected_id))
            result.read_seconds = time.perf_counter() - t1
