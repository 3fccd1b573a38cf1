"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave with MoE.

[arXiv:2403.19887; hf]  72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2.  Super-block of 8 layers: 7×Mamba (SSD) +
1×attention (index 3); MoE replaces the MLP in every 2nd layer.

Hardware-adaptation note (DESIGN.md §7): Jamba uses Mamba-1 selective-scan
blocks; we substitute the Mamba2 SSD chunked form (state 128) because its
intra-chunk matmuls map onto the MXU — the published 1:7 interleave, GQA
attention and MoE placement are preserved.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    hybrid_block=8,
    attn_index=3,
    ssm_state=128,
    ssm_head_dim=64,
    rope_theta=1e6,
    notes="hybrid SSM+attn; long_500k RUNS (63/72 layers are O(1)-state).",
)
