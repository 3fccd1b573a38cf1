"""mamba2-1.3b — attention-free SSM with SSD (state-space duality).

[arXiv:2405.21060; unverified]  48L d_model=2048 (attn-free) vocab=50280,
ssm_state=128.  d_inner = 2×d_model = 4096, head_dim 64 → 64 SSD heads.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,               # mamba blocks have no separate MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    notes="pure SSM; long_500k RUNS (O(1) recurrent state decode).",
)
