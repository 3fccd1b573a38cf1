"""repro_torch.service — the async scatter-gather query service.

The serving-grade face of the byte-offset index: many small concurrent
lookup/extract requests are re-coalesced into the large batches the
sharded :class:`~repro_torch.core.store.IndexStore` and the pipelined
:mod:`~repro_torch.core.reader` engine are built for — and served
fault-tolerantly: replica endpoints sit behind a transport seam with
health tracking, per-probe deadlines, hedged requests, and degraded-mode
partial results when a shard range is unreachable.

Scatter-gather shard fan-out      → :mod:`repro_torch.service.router`
Replica endpoints + fault inject  → :mod:`repro_torch.service.transport`
Replica/shard health tracking     → :mod:`repro_torch.service.health`
Continuous micro-batching queue   → :mod:`repro_torch.service.scheduler`
Typed facade (lookup/fetch/stats) → :mod:`repro_torch.service.api`
Closed-loop load generator        → :mod:`repro_torch.service.loadgen`
"""

from .api import QueryService, ServiceConfig
from .health import DEAD, DEGRADED, REPLICA_WIDE, UP, HealthTracker
from .loadgen import LoadReport, run_closed_loop
from .router import (
    LookupBatchResult,
    RouterStats,
    ShardRouter,
    SimilarResult,
)
from .scheduler import MicroBatcher, SchedulerStats
from .transport import (
    FaultInjectingTransport,
    FlakyError,
    LocalTransport,
    ProbeTimeoutError,
    ShardDownError,
    ShardTransport,
    TransportError,
)

__all__ = [
    "DEAD",
    "DEGRADED",
    "FaultInjectingTransport",
    "FlakyError",
    "HealthTracker",
    "LoadReport",
    "LocalTransport",
    "LookupBatchResult",
    "MicroBatcher",
    "ProbeTimeoutError",
    "QueryService",
    "REPLICA_WIDE",
    "RouterStats",
    "SchedulerStats",
    "ServiceConfig",
    "ShardDownError",
    "ShardRouter",
    "ShardTransport",
    "SimilarResult",
    "TransportError",
    "UP",
    "run_closed_loop",
]
