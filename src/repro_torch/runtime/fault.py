"""Run coordination: heartbeats, failure detection, backoff, elastic
restart.

The port's copy of ``repro.runtime.fault``:

* every worker or replica renews a **heartbeat file** (``hb_<rank>``)
  under a run directory;
* :class:`FailureDetector` scans heartbeats; a worker whose heartbeat is
  older than ``timeout`` is declared dead;
* :class:`BackoffPolicy` paces the re-probing of dead replicas
  (:class:`~repro_torch.service.health.HealthTracker`);
* :class:`ElasticPlan` re-carves the data-parallel extent for the
  survivors, and :func:`run_with_failures` drives training through
  injected failures, restarting each time from the last checkpoint.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

__all__ = [
    "BackoffPolicy",
    "ElasticPlan",
    "FailureDetector",
    "FailureLog",
    "Heartbeat",
    "run_with_failures",
]


class Heartbeat:
    def __init__(self, rundir: Path, rank: int):
        self.path = Path(rundir) / f"hb_{rank:05d}"
        self.rank = rank

    def beat(self, step: int) -> None:
        # with_name, not with_suffix: suffix replacement rewrites anything
        # after the last dot of the final component, so a dotted file name
        # would lose part of its rank; and the tmp name carries the pid AND
        # thread ident so neither two processes nor two pool threads beating
        # the same rank ever interleave writes into one tmp file
        # (os.replace keeps the publish itself atomic).
        tmp = self.path.with_name(
            f"{self.path.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        )
        try:
            tmp.write_text(json.dumps({"step": step, "t": time.time()}))
            os.replace(tmp, self.path)
        except BaseException:
            tmp.unlink(missing_ok=True)
            raise

    def read(self) -> Optional[dict]:
        try:
            return json.loads(self.path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None


class FailureDetector:
    """Coordinator-side: who is alive, who missed their deadline."""

    def __init__(self, rundir: Path, n_workers: int, timeout: float = 5.0):
        self.rundir = Path(rundir)
        self.n_workers = n_workers
        self.timeout = timeout

    def alive(self) -> List[int]:
        now = time.time()
        out = []
        for r in range(self.n_workers):
            hb = Heartbeat(self.rundir, r).read()
            if hb is not None and now - hb["t"] <= self.timeout:
                out.append(r)
        return out

    def dead(self) -> List[int]:
        a = set(self.alive())
        return [r for r in range(self.n_workers) if r not in a]


@dataclass(frozen=True)
class BackoffPolicy:
    """Exponential backoff schedule (dead-replica re-probe, retry waits).

    ``delay(attempt)`` is ``base_s * multiplier**attempt`` capped at
    ``cap_s`` — attempt 0 is the first wait after the failure that opened
    the backoff window.  Shared by the serving tier's
    :class:`~repro_torch.service.health.HealthTracker` (how long a dead replica
    stays unprobed) and any coordinator that wants paced re-admission.
    """

    base_s: float = 0.2
    multiplier: float = 2.0
    cap_s: float = 5.0

    def delay(self, attempt: int) -> float:
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0, got {attempt}")
        return float(min(self.cap_s, self.base_s * self.multiplier ** attempt))


@dataclass(frozen=True)
class ElasticPlan:
    """Mesh + sampler re-carve after a failure."""

    n_dp: int
    n_model: int

    @staticmethod
    def for_survivors(n_survivors: int, n_model: int) -> "ElasticPlan":
        """Largest dp extent that the survivors can host (model size fixed:
        TP groups must stay whole — a lost chip kills its whole TP group)."""
        if n_survivors < 1:
            raise RuntimeError("no survivors")
        return ElasticPlan(n_dp=max(1, n_survivors), n_model=n_model)


@dataclass
class FailureLog:
    events: List[dict] = field(default_factory=list)

    def record(self, **kw) -> None:
        self.events.append(dict(kw, t=time.time()))


def run_with_failures(
    total_steps: int,
    train_chunk: Callable[[int, int, int], Tuple[int, dict]],
    fail_at: Dict[int, int],
    initial_dp: int = 4,
) -> FailureLog:
    """Drive training through injected failures.

    ``train_chunk(start_step, until_step, n_dp) -> (reached_step, info)``
    runs training (checkpointing inside) and returns where it stopped.
    ``fail_at`` maps step → number of dp shards lost at that step.
    The loop restarts each time from the last checkpoint with the reduced
    dp extent, exactly as the coordinator would.
    """
    log = FailureLog()
    n_dp = initial_dp
    step = 0
    pending = dict(fail_at)
    while step < total_steps:
        # a failure scheduled at the current step (including step 0, before
        # any training has run) applies before the next chunk launches —
        # the chunk must already see the reduced dp extent
        if step in pending:
            lost = pending.pop(step)
            n_dp = max(1, n_dp - lost)
            log.record(kind="failure", at=step, lost=lost, new_dp=n_dp)
        # next failure boundary in this chunk (if any)
        upcoming = sorted(s for s in pending if s > step)
        until = min([total_steps] + upcoming)
        reached, info = train_chunk(step, until, n_dp)
        log.record(kind="chunk", start=step, until=until, reached=reached,
                   n_dp=n_dp, **info)
        step = reached
    return log
