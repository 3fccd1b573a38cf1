"""Shared model substrate of the port: norms, RoPE, GQA attention, the
SwiGLU MLP and the embeddings (the part of the reference's
``models/common.py`` that serving needs).

Conventions
-----------
* Layers are ``nn.Module``s holding only their parameters, under the
  reference's names (``wq``, ``wk``, ``wv``, ``wo``, ``bq`` ..., ``wg``,
  ``wu``, ``wd``, ``table``, ``unembed``); the reference's functions keep
  their names and take the module where the reference took a params dict.
* The reference keeps float32 masters and casts each matrix to the compute
  dtype at every use; the port stores each matrix in the compute dtype,
  cast once at load, which gives the same values.  Norm weights stay
  float32, as ``rmsnorm`` reads them.
* Full-sequence attention goes through ``flash_attention`` (the CUDA kernel
  for a CUDA tensor, the plain version on the CPU).  One-token decode is
  the reference's default unchunked path: a grouped product with float32
  accumulation and a float32 result, masked softmax, product with V.  It
  updates the cache in place (``index_put_`` at each row's slot), where
  the reference rebuilds it functionally and donates the old one.
* ``init_*`` draw the reference's distributions from a ``torch.Generator``
  on the target device; the numbers differ from ``jax.random``'s, so
  parity runs carry the reference's weights across (``models/weights.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import flash_attention

__all__ = [
    "Attention",
    "Embed",
    "RMSNorm",
    "SwiGLU",
    "apply_rope",
    "attention_apply",
    "attention_decode",
    "attention_init",
    "compute_dtype",
    "dense_init",
    "embed_apply",
    "embed_init",
    "last_token_logits",
    "mlp_apply",
    "mlp_init",
    "rmsnorm",
    "rmsnorm_init",
    "rope_freqs",
    "unembed_logits",
]

NEG_INF = -1e30


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    # serving modules: no gradients are taken through the weights
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """He-style float32 init, ``scale * N(0, 1)`` with ``scale`` defaulting
    to ``1 / sqrt(fan_in)``, on the generator's device."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return scale * torch.randn(shape, generator=generator,
                               device=generator.device, dtype=torch.float32)


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, weight: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.weight = _param(weight.float())
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: ``wq (D, H*Dh)``, ``wk, wv (D, Hkv*Dh)``,
    ``wo (H*Dh, D)``, and the qkv biases where the config has them."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (
            None if b is None else _param(b) for b in (bq, bk, bv)
        )


def attention_init(cfg: ModelConfig, generator: torch.Generator) -> Attention:
    cdt = compute_dtype(cfg)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ws = [dense_init(s, generator).to(cdt)
          for s in ((d, h * dh), (d, hkv * dh), (d, hkv * dh), (h * dh, d))]
    biases = [None] * 3
    if cfg.qkv_bias:
        biases = [torch.zeros((n,), dtype=cdt, device=generator.device)
                  for n in (h * dh, hkv * dh, hkv * dh)]
    return Attention(*ws, *biases)


def _qkv(attn: Attention, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh) in compute dtype."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ attn.wq
    k = x @ attn.wk
    v = x @ attn.wv
    if cfg.qkv_bias:
        q = q + attn.bq
        k = k + attn.bk
        v = v + attn.bv
    return q.view(b, s, h, dh), k.view(b, s, hkv, dh), v.view(b, s, hkv, dh)


def attention_apply(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                   # (B, S, D)
    positions: torch.Tensor,           # (S,) or (B, S)
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source (B, F, D)
) -> torch.Tensor:
    """Full-sequence attention (train / prefill / cross)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_from is None:
        q, k, v = _qkv(attn, cfg, x)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        # cross attention: q from x, k/v from the encoder output (no RoPE)
        f = kv_from.shape[1]
        q = (x @ attn.wq).view(b, s, h, dh)
        k = (kv_from @ attn.wk).view(b, f, hkv, dh)
        v = (kv_from @ attn.wv).view(b, f, hkv, dh)
        causal, window = False, None
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, window=window)       # (B, H, S, Dh)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return out @ attn.wo


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two batched operands in the cache dtype, summed and
    returned in float32 (the reference's ``preferred_element_type``)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*lead, *out.shape[-2:])
    # products of bfloat16 values are exact in float32
    return torch.matmul(a.float(), b.float())


def attention_decode(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, 1, D)
    pos: torch.Tensor,                  # (B,) absolute position of the new token
    cache: Dict[str, torch.Tensor],     # {"k","v"}: (B, Hkv, S_slots, Dh)
    window: Optional[int] = None,
    use_rope: bool = True,
    update_cache: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  Contiguous cache when ``window is None`` (slot =
    absolute position); ring buffer otherwise (slot = pos % window).  The
    new key and value are written into ``cache`` in place; a slot past the
    end is clamped to the last one, as the reference's
    ``dynamic_update_slice`` clamps it."""
    b = x.shape[0]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // hkv
    q, k, v = _qkv(attn, cfg, x)                 # (B,1,H,Dh) / (B,1,Hkv,Dh)
    if use_rope:
        p1 = pos[:, None]
        q = apply_rope(q, p1, cfg.rope_theta)
        k = apply_rope(k, p1, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    slots = k_cache.shape[2]
    if update_cache:
        slot = (pos % window if window is not None else pos).clamp(max=slots - 1)
        rows = torch.arange(b, device=x.device)
        k_cache[rows, :, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, :, slot] = v[:, 0].to(v_cache.dtype)

    idx = torch.arange(slots, device=x.device)[None, :]       # (1, S_slots)
    if window is None:
        valid = idx <= pos[:, None]
    else:
        # ring buffer: slot s holds token t = pos - ((pos - s) mod W)
        valid = pos[:, None] - (pos[:, None] - idx) % window >= 0
    qg = q[:, 0].reshape(b, hkv, g, dh).to(k_cache.dtype)
    s = _matmul_f32(qg, k_cache.transpose(2, 3)) / math.sqrt(dh)  # (B,Hkv,G,S)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = _matmul_f32(p.to(v_cache.dtype), v_cache)                 # (B,Hkv,G,Dh)
    ctx = ctx.reshape(b, h * dh).to(compute_dtype(cfg))
    return (ctx @ attn.wo)[:, None, :], cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``wg, wu (D, F)``, ``wd (F, D)``."""

    def __init__(self, wg, wu, wd):
        super().__init__()
        self.wg, self.wu, self.wd = map(_param, (wg, wu, wd))


def mlp_init(cfg: ModelConfig, generator: torch.Generator,
             d_ff: Optional[int] = None) -> SwiGLU:
    cdt = compute_dtype(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return SwiGLU(*(dense_init(s, generator).to(cdt)
                    for s in ((d, f), (d, f), (f, d))))


def mlp_apply(mlp: SwiGLU, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ mlp.wg) * (x @ mlp.wu)) @ mlp.wd


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """``table (V, D)`` and, unless the embeddings are tied, ``unembed
    (D, V)``."""

    def __init__(self, table, unembed=None):
        super().__init__()
        self.table = _param(table)
        self.unembed = None if unembed is None else _param(unembed)


def embed_init(cfg: ModelConfig, generator: torch.Generator) -> Embed:
    cdt = compute_dtype(cfg)
    v, d = cfg.vocab_size, cfg.d_model
    table = dense_init((v, d), generator, scale=0.02).to(cdt)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = dense_init((d, v), generator, scale=0.02).to(cdt)
    return Embed(table, unembed)


def embed_apply(embed: Embed, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return embed.table[tokens]


def unembed_logits(embed: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = embed.table.T if cfg.tie_embeddings else embed.unembed
    return x @ w


def last_token_logits(
    embed: Embed,
    cfg: ModelConfig,
    hidden: torch.Tensor,                   # (B, S, D) final hidden states
    lengths: Optional[torch.Tensor] = None,  # (B,) true prompt lengths
    offset: int = 0,                        # prepended non-text positions (VLM)
) -> torch.Tensor:
    """Logits at each sequence's true last prompt position: a right-padded
    ragged batch reads row ``offset + lengths - 1``, not a pad row.
    ``lengths=None`` reads the last row."""
    if lengths is None:
        last = hidden[:, -1]
    else:
        rows = torch.arange(hidden.shape[0], device=hidden.device)
        last = hidden[rows, lengths.long() + offset - 1]
    return unembed_logits(embed, cfg, last[:, None])[:, 0]
