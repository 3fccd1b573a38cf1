"""ShardTransport — the replica-endpoint seam under the ShardRouter.

The router holds a checkout pool of in-process :class:`IndexStore`
replicas; multi-host serving needs the same scatter/gather/merge logic
to run against *remote* shard sets, and fault-tolerant serving needs a
place to observe (and, in tests, to inject) endpoint failures.  Both
want the identical seam: everything the router asks of a replica goes
through a :class:`ShardTransport` —

* :class:`LocalTransport` wraps one ``IndexStore`` handle (today's
  in-process deployment; replicas share pages through the OS cache);
* :class:`FaultInjectingTransport` wraps any transport with a seeded,
  deterministic fault plan — per-shard latency distributions, transient
  error rates, and hard "shard down" states, all settable live while
  traffic is flowing (the ``--chaos`` machinery and the chaos tests);
* the multi-host follow-up drops in an RPC stub with the same surface
  and the router, health tracker, hedging, and degraded-mode logic are
  unchanged.

Failure taxonomy is typed: :class:`ShardDownError` (hard down state),
:class:`ProbeTimeoutError` (deadline exceeded), :class:`FlakyError`
(injected transient).  All derive from :class:`TransportError`, which is
what the router's failover path catches — anything else escaping a
transport is a bug and propagates.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from random import Random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.store import IndexStore, digest_u64, shard_of

__all__ = [
    "FaultInjectingTransport",
    "FlakyError",
    "LocalTransport",
    "ProbeTimeoutError",
    "ShardDownError",
    "ShardTransport",
    "TransportError",
    "error_kind",
]


class TransportError(RuntimeError):
    """Base of every expected (retriable / failover-able) probe failure."""

    def __init__(self, message: str, shard: Optional[int] = None):
        super().__init__(message)
        self.shard = shard


class ShardDownError(TransportError):
    """The endpoint's shard (or the whole endpoint) is hard-down."""


class ProbeTimeoutError(TransportError):
    """The probe exceeded its deadline at the endpoint."""


class FlakyError(TransportError):
    """Injected transient failure (a retry against a sibling should win)."""


def error_kind(exc: BaseException) -> str:
    """Map an exception to the health/stats taxonomy bucket."""
    if isinstance(exc, ShardDownError):
        return "down"
    if isinstance(exc, ProbeTimeoutError):
        return "timeout"
    return "error"


class ShardTransport:
    """One replica endpoint: the full probe surface the router needs.

    ``timeout_s`` on every probe is the caller's per-probe deadline.  An
    in-process transport finishes fast and may ignore it; a transport
    that *can* run long (fault injection today, RPC tomorrow) must raise
    :class:`ProbeTimeoutError` once the deadline is spent rather than
    blocking the router's probe slot indefinitely.
    """

    name: str = "transport"
    #: True when probes through this transport can fail or stall by
    #: design — the router then routes every batch through the per-shard
    #: failure-domain path instead of the whole-batch fast path.
    chaotic: bool = False

    # -- exact-key lookups ---------------------------------------------------

    def lookup_all(
        self,
        keys: Sequence[str],
        digests: np.ndarray,
        timeout_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Whole-batch probe (endpoint routes to its shards internally)."""
        raise NotImplementedError

    def lookup_shard(
        self,
        shard: int,
        keys: Sequence[str],
        digests: np.ndarray,
        timeout_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Probe one shard's key slice (the scatter unit = failure domain)."""
        raise NotImplementedError

    # -- similarity ----------------------------------------------------------

    def similar_shard(
        self,
        shard: int,
        fps: np.ndarray,
        k: int,
        q_counts: Optional[np.ndarray] = None,
        timeout_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    def similar_all(
        self,
        fps: np.ndarray,
        k: int,
        timeout_s: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    def close(self) -> None:  # endpoints owning sockets/files override
        pass


class LocalTransport(ShardTransport):
    """In-process endpoint over one :class:`IndexStore` replica handle."""

    def __init__(
        self,
        store: IndexStore,
        name: str = "local",
        probe: Optional[str] = None,
    ):
        self.store = store
        self.name = name
        self.probe = probe

    def lookup_all(self, keys, digests, timeout_s=None):
        return self.store.lookup_batch(
            list(keys), probe=self.probe, digests=digests
        )

    def lookup_shard(self, shard, keys, digests, timeout_s=None):
        # the store's batch path routes by digest internally; a
        # shard-partitioned slice touches exactly that shard
        return self.store.lookup_batch(
            list(keys), probe=self.probe, digests=digests
        )

    def similar_shard(self, shard, fps, k, q_counts=None, timeout_s=None):
        return self.store.similar_shard(
            shard, fps, k, probe=self.probe, q_counts=q_counts
        )

    def similar_all(self, fps, k, timeout_s=None):
        return self.store.similar_batch(fps, k, probe=self.probe)


@dataclass
class _ShardFault:
    """Live-settable fault state of one shard at one endpoint."""

    down: bool = False
    latency_s: float = 0.0
    jitter_s: float = 0.0
    error_rate: float = 0.0

    @property
    def clean(self) -> bool:
        return (
            not self.down
            and self.latency_s <= 0.0
            and self.jitter_s <= 0.0
            and self.error_rate <= 0.0
        )


class FaultInjectingTransport(ShardTransport):
    """Deterministic chaos wrapper around any :class:`ShardTransport`.

    Fault state is per shard (``shard=None`` in the setters targets the
    endpoint-wide default) and settable live — the chaos schedule kills and
    revives shards while closed-loop clients are mid-flight.  Injection
    is seeded and deterministic *per shard*: each shard owns a
    ``Random(seed, shard)`` stream consumed once per probe of that shard,
    so a fixed probe sequence produces a fixed fault sequence regardless
    of which thread carries it.

    Order of effects per probe: hard-down check, then latency (sleeping
    at most the caller's deadline before raising
    :class:`ProbeTimeoutError`), then the transient-error draw.  A
    whole-batch probe inherits the *worst* state of the shards its keys
    touch — a single down shard fails the whole probe, which is exactly
    what pushes the router onto the per-shard failure-domain path.
    """

    chaotic = True

    def __init__(self, inner: ShardTransport, seed: int = 0):
        if not isinstance(inner, LocalTransport):  # pragma: no cover
            raise TypeError(
                "FaultInjectingTransport needs the wrapped endpoint's "
                "store metadata; wrap a LocalTransport"
            )
        self.inner = inner
        self.name = f"chaos({inner.name})"
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._default = _ShardFault()
        self._faults: Dict[int, _ShardFault] = {}
        self._rngs: Dict[int, Random] = {}
        # injection counters (read by tests and the chaos report)
        self.injected: Dict[str, int] = {
            "down": 0, "timeout": 0, "error": 0, "delayed": 0,
        }

    # -- live fault controls -------------------------------------------------

    def _fault(self, shard: Optional[int]) -> _ShardFault:
        if shard is None:
            return self._default
        f = self._faults.get(shard)
        if f is None:
            d = self._default
            f = _ShardFault(d.down, d.latency_s, d.jitter_s, d.error_rate)
            self._faults[shard] = f
        return f

    def kill(self, shard: Optional[int] = None) -> None:
        """Hard-down a shard (or, with ``None``, the whole endpoint)."""
        with self._lock:
            if shard is None:
                self._default.down = True
                for f in self._faults.values():
                    f.down = True
            else:
                self._fault(shard).down = True

    def revive(self, shard: Optional[int] = None) -> None:
        with self._lock:
            if shard is None:
                self._default.down = False
                for f in self._faults.values():
                    f.down = False
            else:
                self._fault(shard).down = False

    def set_latency(
        self,
        latency_ms: float,
        jitter_ms: float = 0.0,
        shard: Optional[int] = None,
    ) -> None:
        with self._lock:
            f = self._fault(shard)
            f.latency_s = max(0.0, latency_ms) / 1e3
            f.jitter_s = max(0.0, jitter_ms) / 1e3

    def set_error_rate(
        self, rate: float, shard: Optional[int] = None
    ) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"error rate must be in [0, 1], got {rate}")
        with self._lock:
            self._fault(shard).error_rate = float(rate)

    def clear(self) -> None:
        """Drop every injected fault (endpoint returns to clean serving)."""
        with self._lock:
            self._default = _ShardFault()
            self._faults.clear()

    # -- injection machinery -------------------------------------------------

    def _rng(self, shard: int) -> Random:
        rng = self._rngs.get(shard)
        if rng is None:
            rng = Random((self.seed << 20) ^ (shard * 0x9E3779B1))
            self._rngs[shard] = rng
        return rng

    def _plan(self, shards: List[int]) -> Tuple[float, bool, Optional[int]]:
        """One locked pass: draw this probe's (delay, flaky, down_shard)."""
        with self._lock:
            delay = 0.0
            flaky = False
            for s in shards:
                f = self._faults.get(s, self._default)
                if f.down:
                    return 0.0, False, s
                if f.clean:
                    continue
                rng = self._rng(s)
                d = f.latency_s + (
                    f.jitter_s * rng.random() if f.jitter_s > 0 else 0.0
                )
                delay = max(delay, d)
                if f.error_rate > 0 and rng.random() < f.error_rate:
                    flaky = True
            return delay, flaky, None

    def _inject(
        self, shards: List[int], timeout_s: Optional[float]
    ) -> None:
        delay, flaky, down = self._plan(shards)
        if down is not None:
            self.injected["down"] += 1
            raise ShardDownError(
                f"{self.name}: shard {down} is down", shard=down
            )
        if delay > 0.0:
            if timeout_s is not None and delay >= timeout_s:
                time.sleep(timeout_s)
                self.injected["timeout"] += 1
                raise ProbeTimeoutError(
                    f"{self.name}: probe exceeded {timeout_s * 1e3:.0f} ms "
                    f"deadline", shard=shards[0] if len(shards) == 1 else None,
                )
            time.sleep(delay)
            self.injected["delayed"] += 1
        if flaky:
            self.injected["error"] += 1
            raise FlakyError(
                f"{self.name}: injected transient failure",
                shard=shards[0] if len(shards) == 1 else None,
            )

    def _touched(self, digests: np.ndarray) -> List[int]:
        st = self.inner.store
        return np.unique(
            shard_of(digests, st.n_shards, st.digest_bits)
        ).tolist()

    # -- probe surface -------------------------------------------------------

    def lookup_all(self, keys, digests, timeout_s=None):
        if digests is None:  # pragma: no cover — router always digests
            digests = digest_u64(list(keys), bits=self.inner.store.digest_bits)
        self._inject(self._touched(np.asarray(digests)), timeout_s)
        return self.inner.lookup_all(keys, digests, timeout_s)

    def lookup_shard(self, shard, keys, digests, timeout_s=None):
        self._inject([int(shard)], timeout_s)
        return self.inner.lookup_shard(shard, keys, digests, timeout_s)

    def similar_shard(self, shard, fps, k, q_counts=None, timeout_s=None):
        self._inject([int(shard)], timeout_s)
        return self.inner.similar_shard(shard, fps, k, q_counts, timeout_s)

    def similar_all(self, fps, k, timeout_s=None):
        st = self.inner.store
        live = [
            s for s in range(st.n_shards)
            if int(st.manifest["shards"][s]["count"]) > 0
        ]
        self._inject(live, timeout_s)
        return self.inner.similar_all(fps, k, timeout_s)

    def close(self) -> None:
        self.inner.close()
