"""Closed-loop load generator for the query service benchmarks.

``clients`` threads each run a closed loop — pick keys, issue one
request, wait for the result, repeat — against any request function.
Closed-loop is the honest shape for the scheduler comparison: a client
cannot have two requests outstanding, so the service's throughput
advantage must come entirely from *coalescing across clients*, never
from one client secretly batching its own stream.

The same generator drives both sides of the comparison:

* **naive**  — ``request_fn`` calls ``IndexStore.lookup_batch`` directly,
  one per-request probe per call (the pre-service architecture);
* **service** — ``request_fn`` calls ``QueryService.lookup``, which rides
  the continuous micro-batching admission queue.

Under chaos the report separates three outcomes that a bare error count
conflates: **failed** requests raised to the client (the fault-tolerant
service should keep this at zero), **degraded** requests that completed
with partial results (``classify`` inspects each result — e.g. "any key
flagged in the batch's degraded mask"), and served-clean requests.  A
``counters_fn`` snapshot (taken at the barrier and after the last client
exits) attributes service-side fault counters — hedges fired, retries,
degraded keys — to exactly this run's window.

Used by ``benchmarks/service_load.py`` (BENCH_service.json) and the
``repro_torch.launch.serve_index`` launcher's ``--load`` / ``--chaos`` modes.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["LoadReport", "run_closed_loop"]


@dataclass
class LoadReport:
    """Merged result of one closed-loop run."""

    clients: int
    seconds: float                 # measured wall window
    requests: int
    keys: int
    errors: int                    # requests that raised to the client
    degraded: int = 0              # requests served with partial results
    # service-side counter deltas over the run window (counters_fn)
    counters: Dict[str, float] = field(default_factory=dict)
    latencies_ms: List[float] = field(repr=False, default_factory=list)

    @property
    def failed(self) -> int:
        """Alias: requests that raised (clients saw an exception)."""
        return self.errors

    @property
    def lookups_per_sec(self) -> float:
        return self.keys / self.seconds if self.seconds > 0 else 0.0

    @property
    def requests_per_sec(self) -> float:
        return self.requests / self.seconds if self.seconds > 0 else 0.0

    def latency_ms(self, p: float) -> float:
        return float(np.percentile(self.latencies_ms, p)) if self.latencies_ms else 0.0

    @property
    def p50_ms(self) -> float:
        return self.latency_ms(50)

    @property
    def p99_ms(self) -> float:
        return self.latency_ms(99)

    def summary(self) -> str:
        out = (
            f"{self.lookups_per_sec:,.0f} lookups/s over {self.clients} "
            f"clients ({self.requests} requests, p50 {self.p50_ms:.2f} ms, "
            f"p99 {self.p99_ms:.2f} ms)"
        )
        if self.errors or self.degraded:
            out += f" [failed {self.errors}, degraded {self.degraded}]"
        hedges = self.counters.get("hedges_fired", 0)
        retries = self.counters.get("retries", 0)
        if hedges or retries:
            out += f" [hedges {hedges}, retries {retries}]"
        return out


def run_closed_loop(
    request_fn: Callable[[List[str]], object],
    key_pool: Sequence[str],
    clients: int = 8,
    duration_s: float = 2.0,
    keys_per_request: int = 1,
    seed: int = 0,
    classify: Optional[Callable[[object], bool]] = None,
    counters_fn: Optional[Callable[[], Dict[str, float]]] = None,
) -> LoadReport:
    """Drive ``request_fn`` from ``clients`` closed-loop threads.

    Each client draws ``keys_per_request`` random keys from ``key_pool``
    per request (seeded per client — runs are reproducible).  All clients
    start together on a barrier; the measured window is the barrier
    release to the last client's exit, so ramp-up isn't credited.

    ``classify(result) -> bool`` (optional) marks a completed request as
    degraded — it still counts toward throughput and latency, since the
    client *was* served, but the report separates it.  ``counters_fn()``
    (optional) returns a cumulative counter dict; the report carries the
    delta across the run window.
    """
    if clients < 1:
        raise ValueError(f"clients must be >= 1, got {clients}")
    if not key_pool:
        raise ValueError("key_pool is empty")
    key_pool = list(key_pool)
    barrier = threading.Barrier(clients + 1)
    stop = threading.Event()
    lats: List[List[float]] = [[] for _ in range(clients)]
    counts = [0] * clients
    errors = [0] * clients
    degraded = [0] * clients

    def client(ci: int) -> None:
        rng = random.Random(seed * 7919 + ci)
        my_lats = lats[ci]
        barrier.wait()
        while not stop.is_set():
            keys = [
                key_pool[rng.randrange(len(key_pool))]
                for _ in range(keys_per_request)
            ]
            t0 = time.perf_counter()
            try:
                result = request_fn(keys)
            except Exception:
                errors[ci] += 1
                continue
            my_lats.append((time.perf_counter() - t0) * 1e3)
            counts[ci] += 1
            if classify is not None and classify(result):
                degraded[ci] += 1

    threads = [
        threading.Thread(target=client, args=(i,), daemon=True)
        for i in range(clients)
    ]
    for t in threads:
        t.start()
    before = dict(counters_fn()) if counters_fn is not None else {}
    barrier.wait()
    t_start = time.perf_counter()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    elapsed = time.perf_counter() - t_start
    after = dict(counters_fn()) if counters_fn is not None else {}

    merged: List[float] = []
    for ls in lats:
        merged.extend(ls)
    n_req = sum(counts)
    return LoadReport(
        clients=clients,
        seconds=elapsed,
        requests=n_req,
        keys=n_req * keys_per_request,
        errors=sum(errors),
        degraded=sum(degraded),
        counters={k: after[k] - before.get(k, 0) for k in after},
        latencies_ms=merged,
    )
