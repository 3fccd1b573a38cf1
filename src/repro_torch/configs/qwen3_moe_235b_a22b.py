"""qwen3-moe-235b-a22b — MoE, 128 experts top-8.

[hf:Qwen/Qwen3-30B-A3B; hf]  94L d_model=4096 64H (GQA kv=4) d_ff=1536
(per expert) vocab=151936, MoE 128e top-8.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,          # qwen3: head_dim fixed at 128 (64H × 128 > d_model)
    n_experts=128,
    experts_per_token=8,
    moe_every=1,
    rope_theta=1e6,
    notes="128e top-8 MoE; long_500k skipped (pure full attention).",
)
