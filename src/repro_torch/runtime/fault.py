"""Run coordination for the serving tier: heartbeats, failure detection,
backoff.

The port's copy of the part of ``repro.runtime.fault`` that the query
service uses:

* every worker or replica renews a **heartbeat file** (``hb_<rank>``)
  under a run directory;
* :class:`FailureDetector` scans heartbeats; a worker whose heartbeat is
  older than ``timeout`` is declared dead;
* :class:`BackoffPolicy` paces the re-probing of dead replicas
  (:class:`~repro_torch.service.health.HealthTracker`).

The elastic-restart part of the reference module (``ElasticPlan``,
``run_with_failures``) belongs to the training slice and is not copied.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

__all__ = [
    "BackoffPolicy",
    "FailureDetector",
    "Heartbeat",
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
