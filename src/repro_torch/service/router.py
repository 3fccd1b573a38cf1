"""ShardRouter — fault-tolerant scatter-gather over shard transports.

One :class:`~repro_torch.core.store.IndexStore` already routes a key batch to
its digest-range shards internally, but it does so sequentially on the
calling thread and assumes every shard answers.  The router is the
serving-grade face of the same contract: it owns ``N`` replica endpoints
of one published store directory behind the :class:`ShardTransport`
seam, partitions each incoming key batch by
:func:`~repro_torch.core.store.shard_of`, scatter-gathers the per-shard probes
across worker pools, and — when an endpoint misbehaves — retries,
hedges, and degrades instead of failing the caller:

* **per-probe deadlines** — every transport probe carries
  ``probe_timeout_ms``; a probe that outlives it is abandoned and the
  shard fails over to a sibling replica;
* **bounded retry-with-backoff** — failed probes retry against the next
  healthy sibling (``max_attempts`` total), with a tiny exponential
  pause between attempts;
* **hedged requests** — when a probe exceeds the domain's rolling p95
  (floored at ``hedge_floor_ms``), a second probe fires at the next
  replica and the first result wins (the loser is abandoned, its
  outcome still feeds health);
* **degraded mode** — when every replica of a shard range is dead or
  deadline-expired, the batch *returns* with those keys flagged in a
  per-key ``degraded`` mask (misses, not exceptions) and the failure
  taxonomy recorded per shard in :class:`RouterStats`.

Health state (up / degraded / dead, exponential-backoff probation of
dead replicas) lives in :class:`~repro_torch.service.health.HealthTracker`,
fed by every probe outcome.  Healthy in-process serving keeps the fast
paths — zero extra thread hops until a transport is chaotic (fault
injection, future RPC stubs) or a failure domain leaves the ``up``
state.

Digesting happens ONCE per batch here (``digest_u64``), and each shard
probe receives its digest slice, so fan-out never re-pays the blake2b
pass.  This is the seam later multi-host serving plugs into: replace
:class:`LocalTransport` with an RPC stub per remote shard-set and the
scatter, gather, merge, health, and hedging logic is unchanged.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import (
    FIRST_COMPLETED,
    ThreadPoolExecutor,
    as_completed,
    wait,
)
from dataclasses import dataclass, field
from pathlib import Path
from typing import (
    Callable,
    Dict,
    List,
    NamedTuple,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from repro_torch.core.fingerprint import popcount_u32
from repro_torch.device import DeviceLike
from repro_torch.core.store import (
    IndexStore,
    QueryStats,
    digest_u64,
    merge_similar_topk,
    shard_of,
)
from repro_torch.runtime.fault import BackoffPolicy

from .health import REPLICA_WIDE, HealthTracker
from .transport import (
    LocalTransport,
    ShardTransport,
    TransportError,
    error_kind,
)

__all__ = [
    "LookupBatchResult",
    "RouterStats",
    "ShardRouter",
    "SimilarResult",
]

DEFAULT_REPLICAS = 2
# Below this many keys a batch probes inline on one replica: task dispatch
# plus pool handoff costs more than the scatter saves (the shard loop
# is GIL-bound numpy; overlap only pays once slices are big enough for
# the release-the-GIL stretches inside searchsorted/bloom to matter).
DEFAULT_MIN_SCATTER_KEYS = 128
DEFAULT_PROBE_TIMEOUT_MS = 1000.0
DEFAULT_MAX_ATTEMPTS = 3
DEFAULT_HEDGE_FLOOR_MS = 10.0
DEFAULT_RETRY_BACKOFF_MS = 1.0


class LookupBatchResult(NamedTuple):
    """``lookup_batch`` rows plus the degraded-mode miss mask.

    ``hit[i]`` is False for keys that are genuinely absent AND for keys
    whose shard could not be probed; ``degraded[i]`` is True only for the
    latter — "we don't know", not "not there".  Callers that ignore the
    mask see plain misses (the pre-fault-tolerance contract).
    """

    file_ids: np.ndarray   # (N,) int32, -1 on miss
    offsets: np.ndarray    # (N,) int64, -1 on miss
    hit: np.ndarray        # (N,) bool
    degraded: np.ndarray   # (N,) bool — shard unreachable, not a real miss


class SimilarResult(NamedTuple):
    """``similar_batch`` top-k planes plus the per-query degraded flag.

    Similarity is a full scan, so a lost shard taints every query in the
    batch equally: ``degraded[i]`` means query ``i``'s top-k was merged
    from the surviving shards only.
    """

    scores: np.ndarray     # (Q, k) float32, -1 pads
    file_ids: np.ndarray   # (Q, k) int32
    offsets: np.ndarray    # (Q, k) int64
    degraded: np.ndarray   # (Q,) bool


@dataclass
class RouterStats:
    """Cumulative routing counters (scatter decisions, shard traffic,
    and the fault-tolerance ledger)."""

    batches: int = 0         # lookup_batch calls served
    keys: int = 0            # keys routed in total
    scattered: int = 0       # batches fanned out across the worker pool
    inline: int = 0          # batches probed inline on one replica
    shard_probes: int = 0    # per-shard probe tasks executed (scattered only)
    # similarity traffic (full-scan modality: every batch touches every
    # shard, so the scatter unit is the shard, not a key partition)
    similar_batches: int = 0
    similar_queries: int = 0        # query fingerprints routed
    similar_scattered: int = 0      # batches fanned out shard-per-task
    similar_inline: int = 0         # batches served whole on one replica
    similar_shard_probes: int = 0   # per-shard similarity tasks executed
    # fault tolerance
    hedges_fired: int = 0    # secondary probes launched past the p95 point
    hedge_wins: int = 0      # hedges that beat their primary
    retries: int = 0         # sibling failovers after a failed/expired probe
    probes_failed: int = 0   # probe attempts that raised a TransportError
    degraded_batches: int = 0   # lookup batches with >= 1 degraded key
    degraded_keys: int = 0      # keys returned behind a dead shard range
    degraded_similar: int = 0   # similarity batches merged from survivors
    # per-shard failure taxonomy: shard (-1 = whole-replica probes) ->
    # {"down"/"timeout"/"error"/"abandoned"/"dead": count}
    errors_per_shard: Dict[int, Dict[str, int]] = field(default_factory=dict)
    # shard traffic of scattered batches (inline batches skip partitioning
    # in the router entirely — the replica routes internally; its
    # QueryStats carry the per-shard truth)
    keys_per_shard: Dict[int, int] = field(default_factory=dict)

    def note_shard_keys(self, sid: np.ndarray) -> None:
        shards, counts = np.unique(sid, return_counts=True)
        for s, c in zip(shards, counts):
            s = int(s)
            self.keys_per_shard[s] = self.keys_per_shard.get(s, 0) + int(c)

    def note_error(self, shard: int, kind: str, n: int = 1) -> None:
        errs = self.errors_per_shard.setdefault(int(shard), {})
        errs[kind] = errs.get(kind, 0) + n


class ShardRouter:
    """Fault-tolerant scatter-gather ``lookup_batch`` over shard transports.

    The router's primary result contract is
    :meth:`IndexStore.lookup_batch` — ``(file_ids, offsets, hit_mask)``
    with misses at ``-1``/``False`` — so everything written against the
    store's batch read surface rides the router unchanged;
    :meth:`lookup_batch_ex` adds the per-key ``degraded`` mask (the
    serving path rides that).  ``stats()`` merges the replicas' per-shard
    :class:`QueryStats` with the router's own scatter + fault accounting,
    and :attr:`health` tracks per-``(replica, shard)`` domain state.

    ``device`` (default ``"cuda"``) is the replicas' store device
    (:meth:`IndexStore.open`): the digest probe and the Tanimoto scan run
    there, and the replicas share one copy of each shard's device tables.

    ``transport_factory(store, idx) -> ShardTransport`` is the
    deployment seam: the default wraps each replica store in a
    :class:`LocalTransport`; chaos runs wrap those in
    :class:`FaultInjectingTransport`; multi-host serving will return RPC
    stubs.
    """

    def __init__(
        self,
        root: Union[str, Path],
        replicas: int = DEFAULT_REPLICAS,
        probe: Optional[str] = None,
        mmap: bool = True,
        device: DeviceLike = "cuda",
        min_scatter_keys: int = DEFAULT_MIN_SCATTER_KEYS,
        preload_digests: bool = True,
        transport_factory: Optional[
            Callable[[IndexStore, int], ShardTransport]
        ] = None,
        probe_timeout_ms: float = DEFAULT_PROBE_TIMEOUT_MS,
        max_attempts: int = DEFAULT_MAX_ATTEMPTS,
        hedge: bool = True,
        hedge_floor_ms: float = DEFAULT_HEDGE_FLOOR_MS,
        hedge_factor: float = 1.0,
        retry_backoff_ms: float = DEFAULT_RETRY_BACKOFF_MS,
        fail_threshold: int = 3,
        health_backoff: Optional[BackoffPolicy] = None,
        health_dir: Optional[Union[str, Path]] = None,
    ):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if probe_timeout_ms <= 0:
            raise ValueError(
                f"probe_timeout_ms must be > 0, got {probe_timeout_ms}"
            )
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self.root = Path(root)
        self.probe = probe
        self.min_scatter_keys = int(min_scatter_keys)
        self.probe_timeout_ms = float(probe_timeout_ms)
        self.max_attempts = int(max_attempts)
        self.hedge = bool(hedge)
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.hedge_factor = float(hedge_factor)
        self.retry_backoff_ms = float(retry_backoff_ms)
        self._stores: List[IndexStore] = [
            IndexStore.open(self.root, mmap=mmap, device=device)
            for _ in range(replicas)
        ]
        first = self._stores[0]
        self.device = first.device
        # replicas share the first store's per-shard device tables (digest
        # columns, fingerprint planes): one copy of each in device memory
        for st in self._stores[1:]:
            st.share_device_tables(first)
        if preload_digests:
            # serving posture: pin the global digest + Bloom planes once
            # and share the read-only arrays across replicas
            planes = first.preload_digest_plane()
            for st in self._stores[1:]:
                st.adopt_planes(planes)
        self.key_mode: str = first.key_mode
        self.n_shards: int = first.n_shards
        self.digest_bits: int = first.digest_bits
        self.fingerprint_bits: Optional[int] = first.fingerprint_bits
        self.file_names: List[str] = first.file_names
        if transport_factory is None:
            transport_factory = lambda st, i: LocalTransport(  # noqa: E731
                st, name=f"replica{i}", probe=probe
            )
        self._transports: List[ShardTransport] = [
            transport_factory(st, i) for i, st in enumerate(self._stores)
        ]
        self._chaotic = any(t.chaotic for t in self._transports)
        self.health = HealthTracker(
            n_replicas=len(self._transports),
            fail_threshold=fail_threshold,
            backoff=health_backoff,
            rundir=Path(health_dir) if health_dir is not None else None,
        )
        # gather pool runs per-shard group tasks; probe pool runs the
        # transport probes those tasks race (primary + hedge + retries).
        # Probes never submit to a pool themselves, so the two tiers
        # cannot deadlock on each other.
        self._gather = ThreadPoolExecutor(
            max_workers=min(8, max(4, replicas)),
            thread_name_prefix="shard-gather",
        )
        self._probe_pool = ThreadPoolExecutor(
            max_workers=min(16, max(4, 2 * replicas)),
            thread_name_prefix="shard-probe",
        )
        self._rr = 0
        self._rr_lock = threading.Lock()
        self.stats = RouterStats()
        self._stats_lock = threading.Lock()
        self._closed = False

    @property
    def replicas(self) -> int:
        return len(self._stores)

    @property
    def transports(self) -> List[ShardTransport]:
        return list(self._transports)

    def __len__(self) -> int:
        return len(self._stores[0])

    def iter_keys(self):
        """Enumerate every key (index-building side; loads shards on replica 0)."""
        return self._stores[0].iter_keys()

    # -- transport selection -------------------------------------------------

    def _next_replica(self) -> int:
        with self._rr_lock:
            r = self._rr
            self._rr = (r + 1) % len(self._transports)
        return r

    def _ft_active(self) -> bool:
        """Route through the failure-domain path?  Chaotic transports can
        stall or fail by design; a non-up health domain means a previously
        clean endpoint started failing."""
        return self._chaotic or self.health.has_unhealthy()

    # -- the fault-tolerant probe core ---------------------------------------

    def _timed_call(self, replica: int, hshard: int, call, timeout_s: float):
        """One transport probe; its outcome always reaches the tracker —
        including probes the router already abandoned (late losers)."""
        t0 = time.monotonic()
        try:
            out = call(self._transports[replica], timeout_s)
        except TransportError as e:
            self.health.on_failure(replica, hshard, error_kind(e))
            raise
        except Exception as e:  # noqa: BLE001 — endpoint bug, still a failure
            self.health.on_failure(replica, hshard, "error")
            raise
        self.health.on_success(replica, hshard, time.monotonic() - t0)
        return out

    def _hedge_after_s(self, replica: int, hshard: int) -> float:
        """Fire the hedge once the primary exceeds its domain's rolling
        p95 (scaled by ``hedge_factor``), floored at ``hedge_floor_ms``
        so cold domains still hedge against injected stalls."""
        floor = self.hedge_floor_ms / 1e3
        p95 = self.health.p95_s(replica, hshard)
        if p95 is None:
            return floor
        return max(p95 * self.hedge_factor, floor)

    def _ft_probe(self, shard: Optional[int], call):
        """Probe one failure domain with deadline, hedging, and sibling
        failover.  ``call(transport, timeout_s)`` runs the actual probe.
        Returns the probe result, or ``None`` when the domain is fully
        degraded (every candidate dead, failed, or deadline-expired)."""
        hshard = REPLICA_WIDE if shard is None else int(shard)
        timeout_s = self.probe_timeout_ms / 1e3
        cands = self.health.candidates(hshard)
        if not cands:
            # every replica dead and inside its backoff window: fail fast
            with self._stats_lock:
                self.stats.note_error(hshard, "dead")
            return None
        cands = cands[: self.max_attempts]
        waits: Dict[object, int] = {}
        hedge_futs = set()
        used = 0
        t_stop = 0.0
        hedge_at: Optional[float] = None

        def fire(as_hedge: bool) -> None:
            nonlocal used, t_stop, hedge_at
            r = cands[used]
            used += 1
            f = self._probe_pool.submit(
                self._timed_call, r, hshard, call, timeout_s
            )
            waits[f] = r
            if as_hedge:
                hedge_futs.add(f)
                hedge_at = None
            else:
                now = time.monotonic()
                t_stop = now + timeout_s
                hedge_at = None
                if self.hedge and used < len(cands):
                    ha = self._hedge_after_s(r, hshard)
                    if ha < timeout_s:
                        hedge_at = now + ha

        fire(as_hedge=False)
        while True:
            now = time.monotonic()
            if waits and now < t_stop:
                t_next = t_stop if hedge_at is None else min(hedge_at, t_stop)
                done, _ = wait(
                    set(waits),
                    timeout=max(0.0, t_next - now),
                    return_when=FIRST_COMPLETED,
                )
                winner = None
                for f in done:
                    r = waits.pop(f)
                    exc = f.exception()
                    if exc is None:
                        winner = f
                    elif isinstance(exc, TransportError):
                        with self._stats_lock:
                            self.stats.probes_failed += 1
                            self.stats.note_error(hshard, error_kind(exc))
                    else:
                        raise exc  # endpoint bug: propagate, don't degrade
                if winner is not None:
                    if winner in hedge_futs:
                        with self._stats_lock:
                            self.stats.hedge_wins += 1
                    return winner.result()
                if done:
                    continue  # a probe failed; race whatever is still up
                if hedge_at is not None and time.monotonic() >= hedge_at:
                    hedge_at = None  # one hedge per attempt, never a spin
                    if used < len(cands):
                        with self._stats_lock:
                            self.stats.hedges_fired += 1
                        fire(as_hedge=True)
                continue
            # deadline expired with probes still in flight, or every
            # in-flight probe failed: abandon and fail over to the next
            # sibling (late completions still feed health via _timed_call)
            if waits:
                with self._stats_lock:
                    self.stats.note_error(hshard, "abandoned", len(waits))
                waits.clear()
                hedge_futs.clear()
            if used >= len(cands):
                return None
            with self._stats_lock:
                self.stats.retries += 1
            time.sleep(
                min(0.05, (self.retry_backoff_ms / 1e3) * (2 ** (used - 1)))
            )
            fire(as_hedge=False)

    # -- exact-key lookups ---------------------------------------------------

    def lookup_batch_ex(
        self, keys: Sequence[str], digests: Optional[np.ndarray] = None
    ) -> LookupBatchResult:
        """Resolve a batch: digest once, partition, scatter, merge —
        returning partial results with a per-key ``degraded`` mask
        instead of raising when shard ranges are unreachable."""
        if self._closed:
            raise RuntimeError("router is closed")
        keys = list(keys)
        n = len(keys)
        if n == 0:
            return LookupBatchResult(
                np.empty(0, dtype=np.int32),
                np.empty(0, dtype=np.int64),
                np.empty(0, dtype=bool),
                np.empty(0, dtype=bool),
            )
        q = (
            digest_u64(keys, bits=self.digest_bits)
            if digests is None
            else np.asarray(digests, dtype=np.uint64)
        )
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.keys += n
        if not self._ft_active():
            try:
                return self._healthy_lookup(keys, q)
            except TransportError:
                # an endpoint failed mid-probe: re-route this batch
                # through the per-shard failure-domain path
                pass
        return self._ft_lookup(keys, q)

    def lookup_batch(
        self, keys: Sequence[str], digests: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The legacy 3-tuple contract (degraded keys read as misses)."""
        r = self.lookup_batch_ex(keys, digests)
        return r.file_ids, r.offsets, r.hit

    def _partition(
        self, q: np.ndarray
    ) -> Tuple[List[Tuple[int, np.ndarray]], np.ndarray]:
        """Group a digest batch by shard: ``([(shard, rows), …], sid)``."""
        n = len(q)
        sid = shard_of(q, self.n_shards, self.digest_bits)
        order = np.argsort(sid, kind="stable")
        uniq, starts = np.unique(sid[order], return_index=True)
        bounds = list(starts) + [n]
        return [
            (int(uniq[i]), order[bounds[i]:bounds[i + 1]])
            for i in range(len(uniq))
        ], sid

    def _healthy_lookup(
        self, keys: List[str], q: np.ndarray
    ) -> LookupBatchResult:
        """The healthy fast paths: inline micro-batches, pooled scatter for
        big ones — no deadline/hedge machinery in the way."""
        n = len(keys)
        groups = None
        if n >= self.min_scatter_keys and len(self._transports) > 1:
            groups, sid = self._partition(q)
        scatter = groups is not None and len(groups) > 1
        with self._stats_lock:
            if scatter:
                self.stats.note_shard_keys(sid)
                self.stats.scattered += 1
                self.stats.shard_probes += len(groups)
            else:
                self.stats.inline += 1

        no_degrade = np.zeros(n, dtype=bool)
        if not scatter:
            tr = self._transports[self._next_replica()]
            fid, off, hit = tr.lookup_all(keys, q)
            return LookupBatchResult(fid, off, hit, no_degrade)

        def probe_group(shard: int, sel: np.ndarray):
            tr = self._transports[self._next_replica()]
            return tr.lookup_shard(
                shard, [keys[i] for i in sel], q[sel]
            )

        file_ids = np.full(n, -1, dtype=np.int32)
        offsets = np.full(n, -1, dtype=np.int64)
        hit = np.zeros(n, dtype=bool)
        # merge in completion order (same discipline as the span engine's
        # depth window): the gather thread scatters results back the
        # moment any shard lands instead of serializing on the slowest
        futs = {
            self._gather.submit(probe_group, s, sel): sel
            for s, sel in groups
        }
        for fut in as_completed(futs):
            sel = futs[fut]
            gfid, goff, ghit = fut.result()
            file_ids[sel] = gfid
            offsets[sel] = goff
            hit[sel] = ghit
        return LookupBatchResult(file_ids, offsets, hit, no_degrade)

    def _ft_lookup(
        self, keys: List[str], q: np.ndarray
    ) -> LookupBatchResult:
        """Per-shard failure-domain path: every shard group probes with
        deadline + failover + hedging; unreachable groups come back as
        degraded misses instead of exceptions."""
        n = len(keys)
        groups, sid = self._partition(q)
        with self._stats_lock:
            if len(groups) > 1:
                self.stats.note_shard_keys(sid)
                self.stats.scattered += 1
                self.stats.shard_probes += len(groups)
            else:
                self.stats.inline += 1

        file_ids = np.full(n, -1, dtype=np.int32)
        offsets = np.full(n, -1, dtype=np.int64)
        hit = np.zeros(n, dtype=bool)
        degraded = np.zeros(n, dtype=bool)

        def probe_group(shard: int, sel: np.ndarray):
            klist = [keys[i] for i in sel]
            dg = q[sel]
            return self._ft_probe(
                shard,
                lambda tr, to: tr.lookup_shard(shard, klist, dg, to),
            )

        futs = {
            self._gather.submit(probe_group, s, sel): (s, sel)
            for s, sel in groups
        }
        for fut in as_completed(futs):
            _s, sel = futs[fut]
            out = fut.result()
            if out is None:
                degraded[sel] = True
                continue
            gfid, goff, ghit = out
            file_ids[sel] = gfid
            offsets[sel] = goff
            hit[sel] = ghit
        if degraded.any():
            with self._stats_lock:
                self.stats.degraded_batches += 1
                self.stats.degraded_keys += int(degraded.sum())
        return LookupBatchResult(file_ids, offsets, hit, degraded)

    # -- similarity scatter-gather -------------------------------------------

    def similar_batch_ex(self, fps: np.ndarray, k: int) -> SimilarResult:
        """Batched Tanimoto top-k: scatter shards, gather, merge.

        Result contract is :meth:`IndexStore.similar_batch` — ``(scores,
        file_ids, offsets)`` each ``(Q, k)``, ordered ``(score desc,
        file_id asc, offset asc)`` with ``-1`` pads — plus a per-query
        ``degraded`` flag.  Similarity is a full scan of every shard's
        plane, so an unreachable shard taints the whole batch: its rows
        simply do not compete in the merge, and ``degraded`` records
        that the top-k came from the survivors only.
        """
        if self._closed:
            raise RuntimeError("router is closed")
        first = self._stores[0]
        fps = first._check_fps(fps)
        qn = fps.shape[0]
        live = [
            s for s in range(self.n_shards)
            if int(first.manifest["shards"][s]["count"]) > 0
        ]
        with self._stats_lock:
            self.stats.similar_batches += 1
            self.stats.similar_queries += qn
            if qn == 0:
                self.stats.similar_inline += 1
        if qn == 0:
            e = np.zeros((0, k))
            return SimilarResult(
                e.astype(np.float32), e.astype(np.int32),
                e.astype(np.int64), np.zeros(0, dtype=bool),
            )
        if not self._ft_active():
            try:
                return self._healthy_similar(fps, k, live)
            except TransportError:
                pass
        return self._ft_similar(fps, k, live)

    def similar_batch(
        self, fps: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The legacy 3-tuple contract (degraded flag dropped)."""
        r = self.similar_batch_ex(fps, k)
        return r.scores, r.file_ids, r.offsets

    def _healthy_similar(
        self, fps: np.ndarray, k: int, live: List[int]
    ) -> SimilarResult:
        qn = fps.shape[0]
        scatter = len(self._transports) > 1 and len(live) > 1
        with self._stats_lock:
            if scatter:
                self.stats.similar_scattered += 1
                self.stats.similar_shard_probes += len(live)
            else:
                self.stats.similar_inline += 1
        no_degrade = np.zeros(qn, dtype=bool)
        if not scatter:
            tr = self._transports[self._next_replica()]
            scores, fids, offs = tr.similar_all(fps, k)
            return SimilarResult(scores, fids, offs, no_degrade)

        qc = popcount_u32(fps).sum(axis=1, dtype=np.int32)  # once per batch

        def probe_shard(s: int):
            tr = self._transports[self._next_replica()]
            return tr.similar_shard(s, fps, k, q_counts=qc)

        futs = [self._gather.submit(probe_shard, s) for s in live]
        # merge_similar_topk is order-insensitive (it re-sorts on the
        # global tie contract), so gather in completion order
        parts = [f.result() for f in as_completed(futs)]
        scores, fids, offs = merge_similar_topk(parts, k)
        return SimilarResult(scores, fids, offs, no_degrade)

    def _ft_similar(
        self, fps: np.ndarray, k: int, live: List[int]
    ) -> SimilarResult:
        qn = fps.shape[0]
        with self._stats_lock:
            if len(live) > 1:
                self.stats.similar_scattered += 1
                self.stats.similar_shard_probes += len(live)
            else:
                self.stats.similar_inline += 1
        qc = popcount_u32(fps).sum(axis=1, dtype=np.int32)

        def probe_shard(s: int):
            return self._ft_probe(
                s,
                lambda tr, to: tr.similar_shard(
                    s, fps, k, q_counts=qc, timeout_s=to
                ),
            )

        futs = {self._gather.submit(probe_shard, s): s for s in live}
        parts = []
        lost = 0
        for f in as_completed(futs):
            out = f.result()
            if out is None:
                lost += 1
            else:
                parts.append(out)
        if parts:
            scores, fids, offs = merge_similar_topk(parts, k)
        else:
            scores = np.full((qn, k), -1.0, dtype=np.float32)
            fids = np.full((qn, k), -1, dtype=np.int32)
            offs = np.full((qn, k), -1, dtype=np.int64)
        degraded = np.full(qn, lost > 0, dtype=bool)
        if lost:
            with self._stats_lock:
                self.stats.degraded_similar += 1
        return SimilarResult(scores, fids, offs, degraded)

    # -- convenience + stats -------------------------------------------------

    def locate_batch(
        self, keys: Sequence[str]
    ) -> List[Optional[Tuple[str, int]]]:
        fid, off, hit = self.lookup_batch(keys)
        return [
            (self.file_names[fid[i]], int(off[i])) if hit[i] else None
            for i in range(len(keys))
        ]

    def lookup(self, key: str) -> Optional[Tuple[str, int]]:
        return self.locate_batch([key])[0]

    def query_stats(self) -> QueryStats:
        """Per-shard probe counters merged across every replica."""
        merged = QueryStats()
        for st in self._stores:
            with st._stats_lock:
                merged.merge(st.stats)
        return merged

    def resident_bytes(self) -> int:
        """Columns faulted in across replicas (mmap pages are shared, so
        this over-counts physical memory by design — it is the per-handle
        view the capacity benchmarks track)."""
        return sum(st.resident_bytes() for st in self._stores)

    def close(self) -> None:
        self._closed = True
        self._gather.shutdown(wait=True, cancel_futures=True)
        self._probe_pool.shutdown(wait=True, cancel_futures=True)
        for tr in self._transports:
            tr.close()

    def __enter__(self) -> "ShardRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
