"""gemma3-12b — dense GQA with 5:1 local:global attention interleave.

[hf:google/gemma-3-1b-pt; unverified]  48L d_model=3840 16H (GQA kv=8)
d_ff=15360 vocab=262144, 128k context.  Local layers use a 1024-token
sliding window; every 6th layer is global — which is why this arch *does*
run long_500k (only 8 of 48 layers hold a full-length KV cache).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_ff=15360,
    vocab_size=262144,
    head_dim=256,          # gemma family: head_dim independent of d_model
    window=1024,
    local_block=6,         # 5 local + 1 global per block
    rope_theta=1e6,
    notes="5:1 local:global; long_500k RUNS (windowed KV on 40/48 layers).",
)
