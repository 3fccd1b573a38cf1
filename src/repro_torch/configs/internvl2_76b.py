"""internvl2-76b — VLM: InternViT frontend (stub) + InternLM2-76B backbone.

[arXiv:2404.16821; unverified]  80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256.  The vision tower is a STUB per instructions:
``input_specs()`` supplies precomputed (B, 256, d_model) patch embeddings
prepended to the token sequence; the LM backbone is real.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    n_img_tokens=256,
    rope_theta=1e6,
    notes="ViT frontend stubbed; long_500k skipped (pure full attention).",
)
