"""moonshot-v1-16b-a3b — MoE (moonlight/kimi family), 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64e top-6.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    experts_per_token=6,
    moe_every=1,
    rope_theta=5e4,
    notes="64e top-6 MoE; long_500k skipped (pure full attention).",
)
