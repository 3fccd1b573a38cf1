"""repro_torch.serve — LM serving engines over the uniform model API.

Two engines share one greedy-token contract (outputs are identical
between them on a given prompt in float32):

Static batched engine (pad → prefill → decode till last finishes)
                                  → :mod:`repro_torch.serve.engine`
Paged KV cache bookkeeping (block pool, free-list, block tables,
prefix index)                     → :mod:`repro_torch.serve.kvcache`
Continuous batching (slot admission per decode step, EOS eviction,
prefix sharing, TTFT/inter-token SLO accounting)
                                  → :mod:`repro_torch.serve.scheduler`
"""

from .engine import Engine, GenerationResult, ServeConfig
from .kvcache import (
    TRASH_BLOCK, BlockManager, PagedCacheSpec, PrefixIndex, blocks_for,
)
from .scheduler import ContinuousEngine, ContinuousStats, EngineClosed

__all__ = [
    "BlockManager",
    "ContinuousEngine",
    "ContinuousStats",
    "Engine",
    "EngineClosed",
    "GenerationResult",
    "PagedCacheSpec",
    "PrefixIndex",
    "ServeConfig",
    "TRASH_BLOCK",
    "blocks_for",
]
