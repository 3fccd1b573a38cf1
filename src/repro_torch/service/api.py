"""QueryService — the typed facade over router → scheduler → reader → cache.

One object owns the whole serving-grade read stack:

    caller ── submit ──► MicroBatcher ── batched probe ──► ShardRouter
                             │                                 │ scatter
                             │                        IndexStore replicas
                             ▼                                 │
                     (file, offset) plan ◄─────── merge ───────┘
                             │
                             ▼
                  reader.stream_plan (coalesced preads, file workers)
                             │         with the shared RecordCache in front
                             ▼
                    verified records / stream

``lookup`` answers "where is this key" through the continuous
micro-batching admission queue, so any number of small concurrent
callers probe as a few big batches.  ``fetch``/``fetch_stream`` carry on
into the async span engine with the service's scan-resistant record
cache in front — the same call a one-off extraction makes, so bulk
integration jobs and high-concurrency serving share one batched read
contract (and one cache, which is why the cache's segmented admission
matters: the bulk sweep must not evict the serving working set).
``fetch_async`` is the fully non-blocking variant: the probe rides the
admission queue, the read phase runs on the service's pools, and the
caller gets a future — end-to-end async through the MicroBatcher.
``fetch_aio`` is the asyncio-native twin (awaitable probe, no parked
thread).  ``similar``/``similar_async`` are the second query modality:
batched Tanimoto top-k over the store's fingerprint planes, coalesced
through their own MicroBatcher so concurrent similarity callers share
shard scans the way lookup callers share probes.

The service owns one long-lived span backend (io_uring rings persist
across fetches; ``ServiceConfig.reader_backend``/``reader_depth``) and
one shared :class:`~repro_torch.core.verify.VerifyBatcher`, so recompute/
digest verification batches combine across every concurrent fetch.

Every layer keeps its own counters; :meth:`stats` merges them into one
dict the launcher and benchmarks report from.
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.cache import RecordCache
from repro_torch.core.extract import (
    ExtractionResult,
    Mismatch,
    assemble_plan,
    extract,
    extract_iter,
)
from repro_torch.core.identifiers import hashed_key
from repro_torch.core.iobackend import resolve_backend
from repro_torch.core.reader import (
    DEFAULT_COALESCE_GAP,
    DEFAULT_SPAN_GUESS,
    DEFAULT_WORKERS,
    ReadStats,
    stream_plan,
)
from repro_torch.core.records import RecordStore
from repro_torch.core.verify import VerifyBatcher
from repro_torch.device import DeviceLike

from repro_torch.runtime.fault import BackoffPolicy

from .router import (
    DEFAULT_HEDGE_FLOOR_MS,
    DEFAULT_MAX_ATTEMPTS,
    DEFAULT_MIN_SCATTER_KEYS,
    DEFAULT_PROBE_TIMEOUT_MS,
    DEFAULT_REPLICAS,
    LookupBatchResult,
    ShardRouter,
    SimilarResult,
)
from .scheduler import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MAX_WAIT_MS,
    MicroBatcher,
)

__all__ = ["QueryService", "ServiceConfig"]


@dataclass
class ServiceConfig:
    """Knobs for the full router → scheduler → reader → cache stack."""

    # where the stores' probe and Tanimoto scan and the verifier's digest
    # compare run: "cuda" (the default) or "cpu"
    device: DeviceLike = "cuda"
    # router
    replicas: int = DEFAULT_REPLICAS
    probe: Optional[str] = None            # IndexStore probe backend
    min_scatter_keys: int = DEFAULT_MIN_SCATTER_KEYS
    preload_digests: bool = True           # pin the global digest plane
    # scheduler
    max_batch: int = DEFAULT_MAX_BATCH
    max_wait_ms: float = DEFAULT_MAX_WAIT_MS
    # record cache (shared across every fetch path)
    cache_records: int = 8192
    cache_bytes: Optional[int] = None
    # read engine
    read_workers: int = DEFAULT_WORKERS
    coalesce_gap: int = DEFAULT_COALESCE_GAP
    span_guess: int = DEFAULT_SPAN_GUESS
    verify: bool = True
    # span I/O backend: "auto"/"uring"/"thread"/"mmap"; None reads
    # REPRO_READER_BACKEND.  The service owns ONE long-lived backend
    # instance (io_uring rings persist across fetches).
    reader_backend: Optional[str] = None
    # in-flight spans per file worker (None -> REPRO_READER_DEPTH)
    reader_depth: Optional[int] = None
    # verification backend for the shared VerifyBatcher: "auto" (vector
    # recompute + device digest compare when live), "vector", "process",
    # or the legacy per-record "string"/"digest" paths
    verify_backend: str = "auto"
    # similarity: the fixed k every coalesced Tanimoto probe runs at.
    # Per-call k <= this rides the shared batch (the top-k contract is
    # prefix-stable: the top-j of a top-k probe IS the top-j); larger k
    # bypasses the scheduler and probes alone.
    similar_top_k: int = 32
    # fault tolerance (router probe deadlines / failover / hedging —
    # active when transports are chaotic or a failure domain degrades)
    probe_timeout_ms: float = DEFAULT_PROBE_TIMEOUT_MS
    probe_attempts: int = DEFAULT_MAX_ATTEMPTS   # total tries per shard probe
    hedge: bool = True
    hedge_floor_ms: float = DEFAULT_HEDGE_FLOOR_MS
    hedge_factor: float = 1.0
    fail_threshold: int = 3        # consecutive failures before "dead"
    backoff_base_s: float = 0.2    # dead-replica re-probe schedule
    backoff_cap_s: float = 5.0
    health_dir: Optional[str] = None  # heartbeat files for the detector


class QueryService:
    """Async scatter-gather query service over one published index store.

    ``records`` is the SDF corpus (:class:`RecordStore`); ``store`` is the
    ``save_sharded`` directory or an already-built :class:`ShardRouter`.
    The service is thread-safe by construction — that is its point: call
    :meth:`lookup`/:meth:`fetch` from as many threads as you like and the
    scheduler coalesces them.
    """

    def __init__(
        self,
        records: RecordStore,
        store: Union[str, Path, ShardRouter],
        config: Optional[ServiceConfig] = None,
        cache: Optional[RecordCache] = None,
    ):
        self.records = records
        self.config = config or ServiceConfig()
        if isinstance(store, ShardRouter):
            self.router = store
            self._owns_router = False
        else:
            self.router = ShardRouter(
                store,
                replicas=self.config.replicas,
                probe=self.config.probe,
                device=self.config.device,
                min_scatter_keys=self.config.min_scatter_keys,
                preload_digests=self.config.preload_digests,
                probe_timeout_ms=self.config.probe_timeout_ms,
                max_attempts=self.config.probe_attempts,
                hedge=self.config.hedge,
                hedge_floor_ms=self.config.hedge_floor_ms,
                hedge_factor=self.config.hedge_factor,
                fail_threshold=self.config.fail_threshold,
                health_backoff=BackoffPolicy(
                    base_s=self.config.backoff_base_s,
                    cap_s=self.config.backoff_cap_s,
                ),
                health_dir=self.config.health_dir,
            )
            self._owns_router = True
        self.cache = cache if cache is not None else RecordCache(
            capacity=self.config.cache_records,
            max_bytes=self.config.cache_bytes,
        )
        # the coalesced probe rides the _ex contract so the per-key
        # degraded mask scatters back with each request's rows
        self.batcher = MicroBatcher(
            self.router.lookup_batch_ex,
            max_batch=self.config.max_batch,
            max_wait_ms=self.config.max_wait_ms,
        )
        # long-lived span-engine pool shared by every fetch (per-call pool
        # construction would dominate small fetches)
        self.read_executor = ThreadPoolExecutor(
            max_workers=max(1, self.config.read_workers),
            thread_name_prefix="svc-reader",
        )
        # One span backend for the service's lifetime (io_uring rings and
        # their fds are per-thread and expensive to rebuild per fetch) and
        # one VerifyBatcher, so verification batches combine across every
        # concurrent fetch — service-wide continuous verify batching.
        self.read_backend = resolve_backend(self.config.reader_backend)
        self.verifier = VerifyBatcher(
            self.config.verify_backend, device=self.config.device
        )
        # tiny pool that runs fetch_async read phases off the scheduler's
        # flush thread (the probe callback must never do blocking I/O)
        self._orchestrator = ThreadPoolExecutor(
            max_workers=2, thread_name_prefix="svc-fetch"
        )
        # similarity admission queue (lazy: a store without a fingerprint
        # plane never pays the second batcher's watchdog thread)
        self._similar_batcher: Optional[MicroBatcher] = None
        self._similar_init_lock = threading.Lock()
        self.read_stats = ReadStats()
        self._read_stats_lock = threading.Lock()
        self._closed = False

    # -- identity ------------------------------------------------------------

    @property
    def key_mode(self) -> str:
        return self.router.key_mode

    def __len__(self) -> int:
        return len(self.router)

    # -- lookup surface (scheduler-coalesced) --------------------------------

    def lookup_async(
        self, keys: Sequence[str]
    ) -> "Future[LookupBatchResult]":
        """Submit a raw lookup; resolves to ``(file_ids, offsets, hit,
        degraded)`` — the fault-tolerant batch contract."""
        return self.batcher.submit(keys)

    def lookup_batch(
        self, keys: Sequence[str], timeout: Optional[float] = None
    ) -> LookupBatchResult:
        """The fault-tolerant batch contract, micro-batched: raw
        ``(file_ids, offsets, hit_mask, degraded_mask)`` with no per-key
        boxing — the hot serving surface (``lookup`` builds name tuples
        on top).  ``degraded[i]`` marks keys whose shard range was
        unreachable: they read as misses, but the truth is unknown."""
        return self.batcher.lookup(keys, timeout=timeout)

    def lookup(
        self, keys: Sequence[str], timeout: Optional[float] = None
    ) -> List[Optional[Tuple[str, int]]]:
        """``[(file_name, offset) | None]`` per key, probe-coalesced."""
        fid, off, hit, _ = self.batcher.lookup(keys, timeout=timeout)
        names = self.router.file_names
        return [
            (names[fid[i]], int(off[i])) if hit[i] else None
            for i in range(len(keys))
        ]

    def __contains__(self, key: str) -> bool:
        return self.lookup([key])[0] is not None

    def plan(
        self,
        targets: Sequence[str],
        key_bits: int = 64,
        sort_offsets: bool = True,
    ):
        """Per-file extraction plan via ONE scheduler-coalesced probe.

        Same contract as :func:`repro_torch.core.extract.plan_extraction`, but
        the location probe goes through the admission queue, so concurrent
        planners share probe batches.
        """
        hashed = self.key_mode == "hashed_key"
        keys = [hashed_key(t, key_bits) if hashed else t for t in targets]
        return assemble_plan(targets, keys, self.lookup(keys), sort_offsets)

    # -- similarity surface (scheduler-coalesced Tanimoto) --------------------

    def _similar_probe_fn(self, rows: Sequence[np.ndarray]):
        """Batched probe for the similarity scheduler: stack the cohort's
        query rows into one plane and scan every shard once for all of
        them at the service-wide ``similar_top_k``.  Returns the
        fault-tolerant quad — the per-query degraded flag is a fourth
        row-aligned column, so it scatters back with each request."""
        fps = np.stack([np.asarray(r, dtype=np.uint32) for r in rows])
        return self.router.similar_batch_ex(fps, self.config.similar_top_k)

    def _similarity_batcher(self) -> MicroBatcher:
        b = self._similar_batcher
        if b is None:
            if self.router.fingerprint_bits is None:
                raise ValueError(
                    "store has no fingerprint plane — republish with "
                    "save_sharded(fingerprint_bits=...) to enable "
                    "similarity queries"
                )
            with self._similar_init_lock:
                b = self._similar_batcher
                if b is None:
                    b = MicroBatcher(
                        self._similar_probe_fn,
                        max_batch=self.config.max_batch,
                        max_wait_ms=self.config.max_wait_ms,
                    )
                    self._similar_batcher = b
        return b

    def similar_async(
        self, fps: np.ndarray, k: Optional[int] = None
    ) -> "Future[SimilarResult]":
        """Submit a similarity batch; resolves like :meth:`similar`.

        The probe rides its own :class:`MicroBatcher` admission queue at
        the fixed ``config.similar_top_k``, so concurrent small batches
        coalesce into one shard scan exactly like lookups do; the
        requested ``k`` is sliced off the shared result (top-k selection
        is prefix-stable under the deterministic tie contract).  ``k``
        larger than ``similar_top_k`` probes alone, uncoalesced.
        """
        k = self.config.similar_top_k if k is None else int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        fps = np.ascontiguousarray(fps, dtype=np.uint32)
        if fps.ndim == 1:
            fps = fps[None, :]
        if fps.shape[0] == 0:
            out: "Future[SimilarResult]" = Future()
            out.set_result(SimilarResult(
                np.zeros((0, k), dtype=np.float32),
                np.zeros((0, k), dtype=np.int32),
                np.zeros((0, k), dtype=np.int64),
                np.zeros(0, dtype=bool),
            ))
            return out
        if k > self.config.similar_top_k:
            out: "Future[SimilarResult]" = Future()
            if not out.set_running_or_notify_cancel():  # pragma: no cover
                return out
            try:
                out.set_result(self.router.similar_batch_ex(fps, k))
            except BaseException as e:  # noqa: BLE001 — delivered to caller
                out.set_exception(e)
            return out
        probe = self._similarity_batcher().submit(list(fps))
        out = Future()

        def _slice(pf: Future) -> None:
            if not out.set_running_or_notify_cancel():  # pragma: no cover
                return
            try:
                scores, fids, offs, deg = pf.result()
                out.set_result(SimilarResult(
                    scores[:, :k], fids[:, :k], offs[:, :k], deg
                ))
            except BaseException as e:  # noqa: BLE001
                out.set_exception(e)

        probe.add_done_callback(_slice)
        return out

    def similar(
        self,
        fps: np.ndarray,
        k: Optional[int] = None,
        timeout: Optional[float] = None,
    ) -> SimilarResult:
        """Blocking batched Tanimoto top-k through the admission queue.

        ``fps`` is ``(Q, W)`` (or a single ``(W,)`` row) of packed uint32
        query fingerprints (:func:`repro_torch.core.fingerprint.fold_fingerprint`);
        returns ``(scores (Q, k) f32, file_ids (Q, k) i32, offsets (Q, k)
        i64, degraded (Q,) bool)`` ordered by ``(score desc, file_id asc,
        offset asc)`` with ``-1`` pads — the
        :meth:`IndexStore.similar_batch` contract plus the degraded-mode
        flag (True when the top-k was merged from surviving shards only),
        coalesced across concurrent callers.
        """
        return self.similar_async(fps, k).result(timeout=timeout)

    # -- record surface (reader engine + shared cache) -----------------------

    def fetch(
        self,
        targets: Sequence[str],
        verify: Optional[bool] = None,
        key_bits: int = 64,
        workers: Optional[int] = None,
    ) -> ExtractionResult:
        """Algorithm 3 through the service: plan, read, verify, account.

        Byte-identical to a direct serial ``extract`` — records in target
        order, ``missing``/``mismatches`` identical — with the plan probe
        coalesced and the reads riding the shared cache + read pool.
        """
        res = extract(
            self.records,
            None,
            targets,
            verify=self.config.verify if verify is None else verify,
            key_bits=key_bits,
            workers=workers,
            coalesce_gap=self.config.coalesce_gap,
            span_guess=self.config.span_guess,
            depth=self.config.reader_depth,
            service=self,
        )
        self._merge_read(res)
        return res

    def fetch_async(
        self,
        targets: Sequence[str],
        verify: Optional[bool] = None,
        key_bits: int = 64,
        workers: Optional[int] = None,
    ) -> "Future[ExtractionResult]":
        """Non-blocking :meth:`fetch`: async end-to-end through the stack.

        The plan probe is submitted to the :class:`MicroBatcher` admission
        queue without waiting (it coalesces with every other in-flight
        probe); when the batch resolves, the span-engine read phase runs
        on the service's pools and the returned future resolves to the
        same :class:`ExtractionResult` a blocking :meth:`fetch` returns.
        The caller's thread never blocks — submit N fetches, then gather.
        """
        do_verify = self.config.verify if verify is None else verify
        hashed = self.key_mode == "hashed_key"
        targets = list(targets)
        keys = [hashed_key(t, key_bits) if hashed else t for t in targets]
        t0 = time.perf_counter()
        probe = self.batcher.submit(keys)
        out: "Future[ExtractionResult]" = Future()

        def read_phase(pf: Future) -> None:
            if not out.set_running_or_notify_cancel():  # pragma: no cover
                return
            try:
                fids, offs, hit, _deg = pf.result()
                locs = self._locations(fids, offs, hit)
                out.set_result(self._read_plan(
                    targets, keys, locs, do_verify, workers,
                    plan_seconds=time.perf_counter() - t0,
                ))
            except BaseException as e:
                out.set_exception(e)

        # hop off the scheduler's flush thread before doing blocking I/O
        probe.add_done_callback(
            lambda pf: self._orchestrator.submit(read_phase, pf)
        )
        return out

    async def fetch_aio(
        self,
        targets: Sequence[str],
        verify: Optional[bool] = None,
        key_bits: int = 64,
        workers: Optional[int] = None,
    ) -> ExtractionResult:
        """asyncio-native :meth:`fetch` — identical result object.

        Unlike :meth:`fetch_async` (which parks the whole request on the
        orchestrator pool), this coroutine awaits the coalesced probe
        with no thread parked anywhere (``asyncio.wrap_future`` bridges
        the MicroBatcher future to the event loop); only the span-read
        phase — actual blocking syscalls — occupies an executor slot,
        and the coroutine awaits that too, so the event loop stays free
        throughout.  Submit many of these concurrently and the probes
        coalesce into shared batches exactly like ``fetch_async``'s.
        """
        do_verify = self.config.verify if verify is None else verify
        hashed = self.key_mode == "hashed_key"
        targets = list(targets)
        keys = [hashed_key(t, key_bits) if hashed else t for t in targets]
        t0 = time.perf_counter()
        fids, offs, hit, _deg = await asyncio.wrap_future(
            self.batcher.submit(keys)
        )
        locs = self._locations(fids, offs, hit)
        plan_seconds = time.perf_counter() - t0
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            self._orchestrator,
            lambda: self._read_plan(
                targets, keys, locs, do_verify, workers,
                plan_seconds=plan_seconds,
            ),
        )

    def _locations(
        self, fids, offs, hit
    ) -> List[Optional[Tuple[str, int]]]:
        names = self.router.file_names
        return [
            (names[fids[i]], int(offs[i])) if hit[i] else None
            for i in range(len(hit))
        ]

    def _read_plan(
        self,
        targets: List[str],
        keys: List[str],
        locs: List[Optional[Tuple[str, int]]],
        do_verify: bool,
        workers: Optional[int],
        plan_seconds: float,
    ) -> ExtractionResult:
        """The blocking span-read phase shared by fetch_async/fetch_aio."""
        plan, missing = assemble_plan(targets, keys, locs)
        res = ExtractionResult()
        res.missing = missing
        res.plan_seconds = plan_seconds
        t1 = time.perf_counter()
        stats = ReadStats()
        found: Dict[str, str] = {}
        for ev in stream_plan(
            self.records,
            plan,
            verify=do_verify,
            workers=(self.config.read_workers
                     if workers is None else workers),
            coalesce_gap=self.config.coalesce_gap,
            span_guess=self.config.span_guess,
            cache=self.cache,
            stats=stats,
            executor=self.read_executor,
            backend=self.read_backend,
            depth=self.config.reader_depth,
            verifier=self.verifier,
        ):
            res.seeks += 1
            if ev.ok:
                found[ev.full_id] = ev.text
            else:
                res.mismatches.append(Mismatch(
                    ev.full_id, ev.found_id, ev.file, ev.offset, ev.key
                ))
        res.records = {t: found[t] for t in targets if t in found}
        res.mismatches.sort(
            key=lambda m: (m.file, m.offset, m.expected_id)
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
        res.read_seconds = time.perf_counter() - t1
        self._merge_read(res)
        return res

    def fetch_stream(
        self,
        targets: Sequence[str],
        verify: Optional[bool] = None,
        key_bits: int = 64,
        result: Optional[ExtractionResult] = None,
    ) -> Iterator[Tuple[str, str]]:
        """Streaming fetch: yield ``(full_id, record)`` as each verifies."""
        own = result if result is not None else ExtractionResult()
        try:
            yield from extract_iter(
                self.records,
                None,
                targets,
                verify=self.config.verify if verify is None else verify,
                key_bits=key_bits,
                coalesce_gap=self.config.coalesce_gap,
                span_guess=self.config.span_guess,
                depth=self.config.reader_depth,
                result=own,
                service=self,
            )
        finally:
            self._merge_read(own)

    def _merge_read(self, res: ExtractionResult) -> None:
        delta = ReadStats(
            files_opened=res.files_opened,
            spans_read=res.spans_read,
            bytes_read=res.bytes_read,
            cache_hits=res.cache_hits,
            records=res.seeks,
            backend=res.read_backend,
            inflight_peak=res.inflight_peak,
            verify_batches=res.verify_batches,
            verify_records=res.verify_records,
            verify_batch_max=res.verify_batch_max,
        )
        with self._read_stats_lock:
            self.read_stats.merge(delta)

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """One merged view across router, scheduler, reader, and cache."""
        qs = self.router.query_stats()
        rs = self.router.stats
        ss = self.batcher.stats
        cs = self.cache.stats
        lat = self.batcher.latency_ms()
        return {
            "router": {
                "replicas": self.router.replicas,
                "n_shards": self.router.n_shards,
                "batches": rs.batches,
                "keys": rs.keys,
                "scattered": rs.scattered,
                "inline": rs.inline,
                "shard_probes": rs.shard_probes,
                "keys_per_shard": dict(sorted(rs.keys_per_shard.items())),
            },
            "fault": {
                "hedges_fired": rs.hedges_fired,
                "hedge_wins": rs.hedge_wins,
                "retries": rs.retries,
                "probes_failed": rs.probes_failed,
                "degraded_batches": rs.degraded_batches,
                "degraded_keys": rs.degraded_keys,
                "degraded_similar": rs.degraded_similar,
                "errors_per_shard": {
                    s: dict(errs)
                    for s, errs in sorted(rs.errors_per_shard.items())
                },
            },
            "health": self.router.health.snapshot(),
            "store": {
                "queries": qs.queries,
                "hits": qs.hits,
                "bloom_rejects": qs.bloom_rejects,
                "bloom_false_positives": qs.bloom_false_positives,
                "digest_probes": qs.digest_probes,
                "verify_collisions": qs.verify_collisions,
                "shards_touched": len(qs.shards_touched),
            },
            "similarity": {
                "fingerprint_bits": self.router.fingerprint_bits,
                "batches": rs.similar_batches,
                "queries": rs.similar_queries,
                "scattered": rs.similar_scattered,
                "inline": rs.similar_inline,
                "shard_probes": rs.similar_shard_probes,
                "fp_rows_scanned": qs.fp_rows_scanned,
                "scheduler": (
                    {
                        "requests": sim.stats.requests,
                        "batches": sim.stats.batches,
                        "mean_batch_keys": sim.stats.mean_batch_keys,
                        "coalesced_batches": sim.stats.coalesced_batches,
                        "coalesced_requests": sim.stats.coalesced_requests,
                        "latency_ms": sim.latency_ms(),
                    }
                    if (sim := self._similar_batcher) is not None
                    else None
                ),
            },
            "scheduler": {
                "requests": ss.requests,
                "keys": ss.keys,
                "batches": ss.batches,
                "mean_batch_keys": ss.mean_batch_keys,
                "batch_keys_max": ss.batch_keys_max,
                "full_flushes": ss.full_flushes,
                "cohort_flushes": ss.cohort_flushes,
                "deadline_flushes": ss.deadline_flushes,
                "immediate_flushes": ss.immediate_flushes,
                "coalesced_batches": ss.coalesced_batches,
                "coalesced_requests": ss.coalesced_requests,
                "cancelled": ss.cancelled,
                "leader_deaths": ss.leader_deaths,
                "latency_ms": lat,
            },
            "cache": {
                "entries": len(self.cache),
                "probation": self.cache.probation_len,
                "protected": self.cache.protected_len,
                "bytes": self.cache.cached_bytes,
                "hits": cs.hits,
                "misses": cs.misses,
                "hit_rate": cs.hit_rate,
                "evictions": cs.evictions,
                "probation_hits": cs.probation_hits,
                "promotions": cs.promotions,
            },
            "read": {
                "backend": self.read_stats.backend or self.read_backend.name,
                "files_opened": self.read_stats.files_opened,
                "spans_read": self.read_stats.spans_read,
                "bytes_read": self.read_stats.bytes_read,
                "cache_hits": self.read_stats.cache_hits,
                "records": self.read_stats.records,
                "inflight_peak": self.read_stats.inflight_peak,
                "verify_batches": self.read_stats.verify_batches,
                "verify_records": self.read_stats.verify_records,
                "verify_batch_max": self.read_stats.verify_batch_max,
            },
        }

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain: bool = False) -> None:
        """Stop the scheduler (cancelling queued lookups unless ``drain``),
        the read pool, and — if this service built it — the router."""
        if self._closed:
            return
        self._closed = True
        self.batcher.close(drain=drain)
        if self._similar_batcher is not None:
            self._similar_batcher.close(drain=drain)
        self._orchestrator.shutdown(wait=drain, cancel_futures=not drain)
        self.read_executor.shutdown(wait=False, cancel_futures=True)
        self.read_backend.close()
        if self._owns_router:
            self.router.close()

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
