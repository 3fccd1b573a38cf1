"""whisper-small — encoder-decoder with conv audio frontend (stub).

[arXiv:2212.04356; unverified]  12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865.  The conv frontend is a STUB per instructions:
``input_specs()`` supplies precomputed (B, 1500, d_model) frame embeddings;
the encoder transformer + decoder (self + cross attention) are real.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,          # decoder layers
    n_enc_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    enc_frames=1500,
    notes=(
        "enc-dec; decode_32k runs (decoder KV + cross cache); "
        "long_500k skipped (full attention, 1500-frame design envelope)."
    ),
)
