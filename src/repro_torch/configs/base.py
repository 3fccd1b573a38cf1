"""Model / run configuration dataclasses.

One ``ModelConfig`` describes every assigned architecture (dense, MoE,
hybrid SSM+attention, pure SSM, encoder–decoder, VLM).  ``ShapeConfig``
describes one input-shape cell (train_4k / prefill_32k / decode_32k /
long_500k).  ``smoke()`` derives the reduced same-family config used by
the CPU smoke tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_by_name"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # MoE replaces MLP in every k-th layer
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- attention pattern ---
    window: Optional[int] = None    # sliding window width (local layers)
    local_block: int = 0            # gemma3: layers per block (5 local + 1 global)
    # --- hybrid (jamba) ---
    hybrid_block: int = 0           # layers per hybrid super-block
    attn_index: int = -1            # position of the attention layer in block
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 0             # precomputed frame embeddings (stub frontend)
    # --- VLM ---
    n_img_tokens: int = 0           # precomputed patch embeddings (stub frontend)
    # --- misc ---
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=min(self.n_layers, 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // max(self.n_heads, 1))),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
        )
        if self.n_experts:
            changes.update(n_experts=8, experts_per_token=2)
        if self.local_block:
            changes.update(local_block=2, n_layers=4, window=64)
        elif self.window:
            changes.update(window=64)
        if self.hybrid_block:
            changes.update(hybrid_block=4, attn_index=1, n_layers=4)
        if self.ssm_state:
            changes.update(ssm_state=32, ssm_head_dim=32, ssm_chunk=32)
        if self.n_enc_layers:
            changes.update(n_enc_layers=2, enc_frames=32)
        if self.n_img_tokens:
            changes.update(n_img_tokens=16)
        return replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    def smoke(self) -> "ShapeConfig":
        return replace(
            self,
            seq_len=min(self.seq_len, 128),
            global_batch=min(self.global_batch, 2),
        )


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in SHAPES]}")
