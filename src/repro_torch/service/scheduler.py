"""Continuous micro-batching: coalesce concurrent lookups into big probes.

The paper's 740x win comes from turning per-record work into one batched
O(N+M) pass — but a serving deployment receives that work as thousands of
*small concurrent* requests, each a handful of keys.  Paid per request,
the batched machinery degenerates: a single-key ``lookup_batch`` costs
roughly as much as a 64-key one (digest setup, Bloom probe, shard
binary-search are all dominated by fixed per-call overhead), and under
the GIL eight client threads probing independently run *slower* than one
thread probing alone — every tiny numpy call is a potential forced GIL
handoff, and per-request probing maximizes how many of those each key
pays.  The :class:`MicroBatcher` re-coalesces: callers ``submit()`` and
get a future; an admission queue forms batches and ONE thread executes
each batch as a single probe, so the per-call fixed costs (and the GIL
handoffs) amortize across every waiting caller.

**Leader-combining execution.**  There is no flusher thread on the hot
path — at micro-batch scale, waking a parked thread costs hundreds of
microseconds, which is the whole latency budget.  Instead the submitting
thread that finds no flush in progress becomes the *leader*: it drains
the queue, executes the probe, scatters results, and keeps draining
while work remains (arrivals during one probe form the next batch —
continuous batching).  A lone caller therefore pays no coordination
latency at all: it leads immediately, probes its own batch of one, and
leaves.

**Batch formation by leadership transfer.**  Under concurrency the batch
is held open briefly so the cohort that is re-arriving (callers the last
probe just answered, plus new ones) can join — but nobody *waits* for
it.  The leader **arms** an admission target (an EMA of recent batch
size, capped by ``max_batch``) with the oldest request's
``max_wait_ms`` deadline, then simply releases leadership; the submitter
whose request completes the cohort inherits leadership *on its own
thread* and probes immediately — a flush with zero wake latency.  A
watchdog thread enforces only the deadline of a cohort that never
completes (the rare path, so its timed sleeps are off the hot path).

Flush taxonomy (counted in :class:`SchedulerStats`):

* **full** — queued keys reached ``max_batch``;
* **cohort** — the armed admission target re-formed;
* **deadline** — the oldest request hit ``max_wait_ms`` mid-cohort;
* **immediate** — no recent coalescing (single-caller regime): no hold;
* **drain** — flushed by ``close(drain=True)``.

Requests are admitted whole (a request's keys never split across
batches), results scatter back as zero-copy row slices of the batch
arrays, and per-request latency (queue wait + total) is accounted in a
bounded window for the service's p50/p99 rows.

**Leader-death containment.**  Probes run on client threads, so a probe
that raises tears down a *client*, not a service worker — the batcher
must contain that.  A failing probe's exception is delivered to every
future of its batch before the leader unwinds (``SystemExit`` /
``KeyboardInterrupt`` re-raise afterwards — shutdown intent is not
swallowed); requests that queued behind the dying leader are rescued by
the watchdog's periodic sweep (any pending, un-armed queue with no live
leader gets led); and ``close(drain=False)`` waits at most
``close_grace_s`` for a wedged leader instead of forever, delivering a
``RuntimeError`` to the in-flight cohort if its leader thread is found
dead.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["BatchResult", "MicroBatcher", "SchedulerStats"]

DEFAULT_MAX_BATCH = 512
DEFAULT_MAX_WAIT_MS = 1.0
# Admission target: the EMA of recent batch size, rounded.  Firing at the
# full estimate (not a fraction) matters because the firing submitter
# probes IMMEDIATELY — there is no wake latency for stragglers to hide
# in, so an undershot target locks in smaller and smaller batches.
_COHORT_FRACTION = 1.0
_EMA_ALPHA = 0.3
# Bounded latency window (requests) for percentile accounting.
_LATENCY_WINDOW = 8192
# Watchdog sweep period: how long an orphaned cohort (its would-be leader
# died before draining) waits for rescue, worst case.
_SWEEP_INTERVAL_S = 0.1
DEFAULT_CLOSE_GRACE_S = 5.0

# A probe result is any tuple of row-sliceable arrays — the classic
# (file_ids, offsets, hit) triple, or the fault-tolerant quad that adds
# the degraded mask.  The batcher slices every column per request.
BatchResult = Tuple[np.ndarray, ...]


@dataclass
class SchedulerStats:
    """Cumulative admission/flush counters."""

    requests: int = 0
    keys: int = 0
    batches: int = 0            # probe executions
    keys_flushed: int = 0       # keys actually probed (excludes cancelled)
    full_flushes: int = 0       # flushed because keys >= max_batch
    cohort_flushes: int = 0     # flushed because the armed target formed
    deadline_flushes: int = 0   # flushed because the oldest hit max_wait
    immediate_flushes: int = 0  # flushed with no hold (single-caller regime)
    drain_flushes: int = 0      # flushed during close(drain=True)
    coalesced_batches: int = 0  # batches that merged >= 2 requests
    coalesced_requests: int = 0 # requests that shared their batch
    cancelled: int = 0          # requests cancelled before probing
    leader_deaths: int = 0      # in-flight cohorts whose leader thread died
    batch_keys_max: int = 0

    @property
    def mean_batch_keys(self) -> float:
        return self.keys_flushed / self.batches if self.batches else 0.0


class _Request:
    __slots__ = ("keys", "future", "t_submit", "t_flush")

    def __init__(self, keys: List[str]):
        self.keys = keys
        self.future: "Future[BatchResult]" = Future()
        self.t_submit = time.monotonic()
        self.t_flush = 0.0


class MicroBatcher:
    """Admission queue + leader-combining flusher over a batched ``probe_fn``.

    ``probe_fn(keys) -> tuple of row-aligned arrays`` is the batched
    backend — the classic ``(file_ids, offsets, hit_mask)`` triple of a
    store, or a :class:`~repro_torch.service.router.ShardRouter`'s
    fault-tolerant quad with the per-key ``degraded`` mask; the batcher
    slices whatever columns come back, so extra planes ride coalescing
    for free.  Each submitted request resolves to the row slice of the
    merged probe that corresponds to its keys (a NamedTuple result type
    is preserved).  Probes execute on submitting threads (the current
    leader); the only owned thread is the deadline watchdog.
    """

    def __init__(
        self,
        probe_fn: Callable[[List[str]], BatchResult],
        max_batch: int = DEFAULT_MAX_BATCH,
        max_wait_ms: float = DEFAULT_MAX_WAIT_MS,
        close_grace_s: float = DEFAULT_CLOSE_GRACE_S,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(f"max_wait_ms must be >= 0, got {max_wait_ms}")
        self.probe_fn = probe_fn
        self.max_batch = int(max_batch)
        self.max_wait = max_wait_ms / 1e3
        self.close_grace_s = float(close_grace_s)
        self.stats = SchedulerStats()
        self.wait_seconds: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self.total_seconds: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self._lock = threading.Lock()    # queue, arming state, counters
        self._leader = threading.Lock()  # at most one probing thread
        self._pending: Deque[_Request] = deque()
        self._pending_keys = 0
        self._armed_target: Optional[int] = None  # cohort keys to admit
        self._armed_deadline = 0.0
        self._armed_evt = threading.Event()       # wakes the watchdog
        self._batch_ema = 1.0                     # recent flushed-keys estimate
        self._coalescing = False                  # last batch merged requests
        self._inflight: Optional[List[_Request]] = None  # leader's cohort
        self._leader_thread: Optional[threading.Thread] = None
        self._stop = False
        self._drain_on_stop = False
        self._watchdog = threading.Thread(
            target=self._watch_deadline, name="micro-batcher-watchdog",
            daemon=True,
        )
        self._watchdog.start()

    # -- client surface ------------------------------------------------------

    def submit(self, keys: Sequence[str]) -> "Future[BatchResult]":
        """Enqueue a request; the future resolves to this request's rows.

        The calling thread may transparently become the leader and execute
        the probe for everything queued.  Cancelling the returned future
        before its batch flushes withdraws the request (its keys are never
        probed).
        """
        req = _Request(list(keys))
        lead = True
        with self._lock:
            if self._stop:
                raise RuntimeError("scheduler is closed")
            self._pending.append(req)
            self._pending_keys += len(req.keys)
            self.stats.requests += 1
            self.stats.keys += len(req.keys)
            if self._armed_target is not None:
                if (
                    self._pending_keys >= self._armed_target
                    or req.t_submit >= self._armed_deadline
                ):
                    self._armed_target = None  # cohort complete: we fire it
                else:
                    lead = False  # batch still forming; don't break it up
        if lead:
            self._maybe_lead()
        return req.future

    def lookup(
        self, keys: Sequence[str], timeout: Optional[float] = None
    ) -> BatchResult:
        """Blocking convenience: ``submit(keys).result(timeout)``."""
        return self.submit(keys).result(timeout)

    # -- leader-combining flusher --------------------------------------------

    def _maybe_lead(self) -> None:
        # Non-blocking: if a leader exists it will see our request; if the
        # batch is armed (forming), the completing submitter leads.  The
        # re-check loop closes the race where the old leader drained to
        # empty and was releasing just as we enqueued.
        while (
            self._pending
            and not self._stop
            and self._armed_target is None
            and self._leader.acquire(blocking=False)
        ):
            try:
                self._drain()
            finally:
                self._leader.release()

    def _take_batch(self) -> List[_Request]:
        """Pop whole requests up to ``max_batch`` keys (caller holds lock)."""
        batch: List[_Request] = []
        taken = 0
        while self._pending:
            if taken and taken + len(self._pending[0].keys) > self.max_batch:
                break
            req = self._pending.popleft()
            self._pending_keys -= len(req.keys)
            # a cancelled future's caller is gone: drop without probing
            if not req.future.set_running_or_notify_cancel():
                self.stats.cancelled += 1
                continue
            batch.append(req)
            taken += len(req.keys)
        return batch

    def _drain(self) -> None:
        while True:
            with self._lock:
                if not self._pending:
                    self._armed_target = None
                    return
                if self._stop and not self._drain_on_stop:
                    return  # close() cancels what we leave behind
                nkeys = self._pending_keys
                if self._stop:
                    reason = "drain"
                elif nkeys >= self.max_batch:
                    reason = "full"
                elif self._coalescing and self.max_wait > 0:
                    target = min(
                        self.max_batch,
                        max(2, round(self._batch_ema * _COHORT_FRACTION)),
                    )
                    now = time.monotonic()
                    deadline = self._pending[0].t_submit + self.max_wait
                    if nkeys < target and now < deadline:
                        # arm and hand leadership to the cohort-completing
                        # submitter (or the watchdog at the deadline)
                        self._armed_target = target
                        self._armed_deadline = deadline
                        self._armed_evt.set()
                        return
                    reason = "cohort" if nkeys >= target else "deadline"
                else:
                    reason = "immediate"
                batch = self._take_batch()
            if batch:
                self._execute(batch, reason)

    def _watch_deadline(self) -> None:
        """Fire armed batches whose cohort never completed, and rescue
        cohorts orphaned by a dead leader (both rare paths)."""
        while True:
            armed = self._armed_evt.wait(timeout=_SWEEP_INTERVAL_S)
            if self._stop:
                return
            if not armed:
                # periodic sweep: pending requests with no armed target
                # normally mean a live leader is about to re-drain them —
                # but if that leader died mid-flush (poisoned probe), the
                # cohort behind it would wait forever.  Leading here is a
                # no-op when a real leader holds the lock.
                with self._lock:
                    orphaned = (
                        bool(self._pending) and self._armed_target is None
                    )
                if orphaned:
                    self._lead_shielded()
                continue
            with self._lock:
                if self._armed_target is None:
                    self._armed_evt.clear()
                    continue
                dt = self._armed_deadline - time.monotonic()
            if dt > 0:
                time.sleep(dt)
                continue  # re-check: the cohort may have fired meanwhile
            with self._lock:
                fire = (
                    self._armed_target is not None
                    and time.monotonic() >= self._armed_deadline
                )
                if fire:
                    self._armed_target = None
            if fire:
                self._lead_shielded()

    def _lead_shielded(self) -> None:
        """Lead from the watchdog: a poisoned probe (``SystemExit``, any
        exception) is already delivered to its futures by ``_execute`` —
        it must not take the rescue thread down with it."""
        try:
            self._maybe_lead()
        except BaseException:  # noqa: BLE001
            pass

    def _execute(self, batch: List[_Request], reason: str) -> None:
        t_flush = time.monotonic()
        if len(batch) == 1:
            all_keys = batch[0].keys
        else:
            all_keys = [k for req in batch for k in req.keys]
        for req in batch:
            req.t_flush = t_flush
        with self._lock:
            self._inflight = batch
            self._leader_thread = threading.current_thread()
        try:
            try:
                cols = self.probe_fn(all_keys)
            except BaseException as e:  # noqa: BLE001 — delivered first
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(e)
                if isinstance(e, (SystemExit, KeyboardInterrupt)):
                    raise  # shutdown intent: unwind the leader thread too
                return
            t_done = time.monotonic()
            # rebuild each request's rows with the probe's own result type
            # (a NamedTuple like LookupBatchResult survives the slicing)
            remake = getattr(type(cols), "_make", tuple)
            row = 0
            for req in batch:
                stop = row + len(req.keys)
                req.future.set_result(remake(c[row:stop] for c in cols))
                row = stop
        finally:
            with self._lock:
                self._inflight = None
                self._leader_thread = None
        # Batch stats are leader-only writes (serialized by the leader
        # lock); submit-side counters take the queue lock.
        st = self.stats
        st.batches += 1
        st.keys_flushed += len(all_keys)
        st.batch_keys_max = max(st.batch_keys_max, len(all_keys))
        if len(batch) >= 2:
            st.coalesced_batches += 1
            st.coalesced_requests += len(batch)
            # The admission estimate tracks DEMAND, not batch size: keys
            # probed plus keys that queued while we probed.  Tracking the
            # flushed size alone is a self-fulfilling target — the cohort
            # fires at it, so the estimate can never learn that more
            # concurrency was available.
            with self._lock:
                leftover = self._pending_keys
            demand = len(all_keys) + leftover
            self._batch_ema = (
                (1 - _EMA_ALPHA) * self._batch_ema + _EMA_ALPHA * demand
            )
            self._coalescing = True
        else:
            self._batch_ema = max(1.0, 0.9 * self._batch_ema)
            self._coalescing = False
        st_field = {
            "full": "full_flushes",
            "cohort": "cohort_flushes",
            "deadline": "deadline_flushes",
            "immediate": "immediate_flushes",
            "drain": "drain_flushes",
        }[reason]
        setattr(st, st_field, getattr(st, st_field) + 1)
        with self._lock:  # latency_ms snapshots these under the same lock
            for req in batch:
                self.wait_seconds.append(req.t_flush - req.t_submit)
                self.total_seconds.append(t_done - req.t_submit)

    # -- latency accounting --------------------------------------------------

    def latency_ms(self, percentiles: Sequence[float] = (50, 99)) -> dict:
        """Request-latency percentiles over the bounded window."""
        with self._lock:
            total = list(self.total_seconds)
            waits = list(self.wait_seconds)
        if not total:
            return {f"p{int(p)}": 0.0 for p in percentiles} | {"mean_wait": 0.0}
        out = {
            f"p{int(p)}": float(np.percentile(total, p)) * 1e3
            for p in percentiles
        }
        out["mean_wait"] = float(np.mean(waits)) * 1e3
        return out

    # -- shutdown ------------------------------------------------------------

    def close(self, drain: bool = False) -> None:
        """Stop admitting.  ``drain=False`` (default) cancels queued
        requests — their futures report ``cancelled()``; ``drain=True``
        probes what is queued first.  A healthy leader mid-probe finishes
        its current batch either way; a leader that never comes back is
        waited out for at most ``close_grace_s``, and if its thread is
        found dead the in-flight cohort's unresolved futures get a
        ``RuntimeError`` instead of hanging their callers forever."""
        with self._lock:
            if self._stop:
                return
            self._stop = True
            self._drain_on_stop = drain
            self._armed_target = None
            self._armed_evt.set()  # release the watchdog so it can exit
        if drain:
            while self._pending:
                with self._leader:
                    self._drain()
            self._watchdog.join(timeout=10)
            return
        # Cancel queued requests first, under the queue lock — NOT after
        # waiting for the leader.  A live leader popping concurrently
        # skips cancelled futures (set_running_or_notify_cancel), so this
        # cannot race a take; and a wedged or dead leader must not be
        # able to block shutdown while callers pile up behind it.
        with self._lock:
            for req in self._pending:
                if req.future.cancel():
                    self.stats.cancelled += 1
            self._pending.clear()
            self._pending_keys = 0
        if self._leader.acquire(timeout=self.close_grace_s):
            self._leader.release()
        else:
            # grace expired.  A wedged-but-alive probe keeps its futures
            # (they resolve if it ever returns); a dead leader thread
            # can never resolve its cohort — deliver the failure now.
            with self._lock:
                t = self._leader_thread
                batch = self._inflight
                if t is not None and not t.is_alive() and batch:
                    self.stats.leader_deaths += 1
                    err = RuntimeError(
                        "micro-batcher leader died mid-flush"
                    )
                    for req in batch:
                        if not req.future.done():
                            req.future.set_exception(err)
                    self._inflight = None
        self._watchdog.join(timeout=10)

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
