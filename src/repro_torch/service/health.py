"""HealthTracker — replica/shard health from observed probe outcomes.

The serving tier's failure detector.  Every router probe lands here as a
success (with its latency) or a failure (with its taxonomy kind), keyed
by the **failure domain** ``(replica, shard)`` — one endpoint can lose a
single shard while serving the rest, so health is tracked at the
granularity faults actually occur at (``shard == REPLICA_WIDE`` for
whole-batch probes).

State machine per domain::

    up ──failure──► degraded ──N consecutive failures──► dead
    ▲                   │                                  │
    └────success────────┘          backoff-paced probation probe
                                            │ success
    up ◄────────────────────────────────────┘  (revival recorded)

Dead domains are excluded from the router's candidate lists until their
exponential backoff (:class:`~repro_torch.runtime.fault.BackoffPolicy`) has
elapsed; then exactly one probation probe is handed out per backoff
window — a success revives the domain (recovery time is recorded), a
failure widens the window.  The tracker also keeps a bounded rolling
latency window per domain, whose p95 is what arms the router's hedged
requests.

It rides the :mod:`repro_torch.runtime.fault` machinery two ways: the backoff
schedule is a :class:`BackoffPolicy`, and — given a ``rundir`` — every
replica's probe successes renew a :class:`Heartbeat` file so the
existing coordinator-side :class:`FailureDetector` (the exact code a
multi-host deployment watches) sees the serving tier's liveness;
:meth:`snapshot` reports its verdict alongside the in-process states.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from pathlib import Path
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.fault import BackoffPolicy, FailureDetector, Heartbeat

__all__ = ["HealthTracker", "REPLICA_WIDE", "UP", "DEGRADED", "DEAD"]

UP = "up"
DEGRADED = "degraded"
DEAD = "dead"

#: pseudo-shard for whole-batch (endpoint-wide) probes
REPLICA_WIDE = -1

_LATENCY_WINDOW = 128
_HEARTBEAT_TIMEOUT_S = 5.0


class _Domain:
    __slots__ = (
        "state", "consec_failures", "latencies", "taxonomy", "successes",
        "dead_since", "next_probe_at", "backoff_attempt", "revivals",
        "last_recovery_s",
    )

    def __init__(self):
        self.state = UP
        self.consec_failures = 0
        self.latencies: Deque[float] = deque(maxlen=_LATENCY_WINDOW)
        self.taxonomy: Counter = Counter()
        self.successes = 0
        self.dead_since = 0.0
        self.next_probe_at = 0.0
        self.backoff_attempt = 0
        self.revivals = 0
        self.last_recovery_s = 0.0


class HealthTracker:
    """Track per-``(replica, shard)`` probe health for the ShardRouter."""

    def __init__(
        self,
        n_replicas: int,
        fail_threshold: int = 3,
        backoff: Optional[BackoffPolicy] = None,
        rundir: Optional[Path] = None,
        heartbeat_interval_s: float = 0.5,
        clock=time.monotonic,
    ):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if fail_threshold < 1:
            raise ValueError(
                f"fail_threshold must be >= 1, got {fail_threshold}"
            )
        self.n_replicas = n_replicas
        self.fail_threshold = fail_threshold
        self.backoff = backoff or BackoffPolicy()
        self.clock = clock
        self._lock = threading.Lock()
        self._domains: Dict[Tuple[int, int], _Domain] = {}
        # optional on-disk liveness: one Heartbeat file per replica, beat
        # on probe success (throttled), watched by the stock
        # coordinator-side FailureDetector
        self._heartbeats: Optional[List[Heartbeat]] = None
        self._detector: Optional[FailureDetector] = None
        self._last_beat = [0.0] * n_replicas
        self._beat_interval = heartbeat_interval_s
        if rundir is not None:
            rundir = Path(rundir)
            rundir.mkdir(parents=True, exist_ok=True)
            self._heartbeats = [
                Heartbeat(rundir, r) for r in range(n_replicas)
            ]
            self._detector = FailureDetector(
                rundir, n_replicas, timeout=_HEARTBEAT_TIMEOUT_S
            )

    def _domain(self, replica: int, shard: int) -> _Domain:
        d = self._domains.get((replica, shard))
        if d is None:
            d = _Domain()
            self._domains[(replica, shard)] = d
        return d

    # -- outcome ingestion ---------------------------------------------------

    def on_success(
        self, replica: int, shard: int, latency_s: float
    ) -> None:
        now = self.clock()
        with self._lock:
            d = self._domain(replica, shard)
            d.consec_failures = 0
            d.successes += 1
            d.latencies.append(latency_s)
            if d.state == DEAD:
                d.revivals += 1
                d.last_recovery_s = now - d.dead_since
            if d.state != UP:
                d.state = UP
                d.backoff_attempt = 0
                d.next_probe_at = 0.0
        if self._heartbeats is not None:
            wall = time.time()
            if wall - self._last_beat[replica] >= self._beat_interval:
                self._last_beat[replica] = wall
                self._heartbeats[replica].beat(step=0)

    def on_failure(self, replica: int, shard: int, kind: str) -> None:
        now = self.clock()
        with self._lock:
            d = self._domain(replica, shard)
            d.taxonomy[kind] += 1
            d.consec_failures += 1
            if d.state == DEAD:
                # failed probation probe: widen the backoff window
                d.backoff_attempt += 1
                d.next_probe_at = now + self.backoff.delay(d.backoff_attempt)
            elif d.consec_failures >= self.fail_threshold:
                d.state = DEAD
                d.dead_since = now
                d.backoff_attempt = 0
                d.next_probe_at = now + self.backoff.delay(0)
            else:
                d.state = DEGRADED

    # -- router queries ------------------------------------------------------

    def state(self, replica: int, shard: int) -> str:
        with self._lock:
            d = self._domains.get((replica, shard))
            return d.state if d is not None else UP

    def has_unhealthy(self) -> bool:
        """Any domain away from ``up``?  (The router's cheap "should I
        take the failure-domain path" check for non-chaotic transports.)"""
        with self._lock:
            return any(d.state != UP for d in self._domains.values())

    def candidates(self, shard: int) -> List[int]:
        """Replica order for one probe: up, then degraded, then dead
        domains whose backoff has elapsed (at most one probation probe is
        handed out per backoff window — the window is advanced here so a
        burst of concurrent batches can't stampede a reviving replica).
        An empty list means every replica is dead and inside its backoff
        window: fail fast, the caller reports the domain degraded."""
        now = self.clock()
        ups: List[int] = []
        degraded: List[int] = []
        probation: List[int] = []
        with self._lock:
            for r in range(self.n_replicas):
                d = self._domains.get((r, shard))
                if d is None or d.state == UP:
                    ups.append(r)
                elif d.state == DEGRADED:
                    degraded.append(r)
                elif now >= d.next_probe_at:
                    d.next_probe_at = now + self.backoff.delay(
                        d.backoff_attempt
                    )
                    probation.append(r)
        return ups + degraded + probation

    def p95_s(self, replica: int, shard: int) -> Optional[float]:
        """Rolling p95 probe latency of one domain (None until sampled)."""
        with self._lock:
            d = self._domains.get((replica, shard))
            if d is None or not d.latencies:
                return None
            lat = list(d.latencies)
        return float(np.percentile(lat, 95))

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            replica_state = []
            taxonomy: Counter = Counter()
            dead_domains = []
            revivals = 0
            last_recovery_s = 0.0
            for r in range(self.n_replicas):
                worst = UP
                for (rr, s), d in self._domains.items():
                    if rr != r:
                        continue
                    if d.state == DEAD:
                        worst = DEAD
                    elif d.state == DEGRADED and worst == UP:
                        worst = DEGRADED
                replica_state.append(worst)
            for (r, s), d in self._domains.items():
                taxonomy.update(d.taxonomy)
                revivals += d.revivals
                last_recovery_s = max(last_recovery_s, d.last_recovery_s)
                if d.state == DEAD:
                    dead_domains.append(
                        {"replica": r,
                         "shard": None if s == REPLICA_WIDE else s}
                    )
        out: Dict[str, object] = {
            "replica_state": replica_state,
            "dead_domains": dead_domains,
            "failures": dict(taxonomy),
            "revivals": revivals,
            "last_recovery_s": last_recovery_s,
        }
        if self._detector is not None:
            out["heartbeat_alive"] = self._detector.alive()
        return out
