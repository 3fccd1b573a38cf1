"""Encoder-decoder transformer of the port (the Whisper family), the
counterpart of the reference's ``models/encdec.py``.

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed ``(B, frames, d_model)`` frame embeddings (the serving engine
feeds zeros).  Encoder: learned positions (``enc_pos``) added to the
frames, then a bidirectional self-attention stack without RoPE.  Decoder:
causal self-attention with RoPE, cross-attention to the encoder output
(no RoPE, no mask), then the SwiGLU MLP.  The reference scans stacked
weights; the port holds one :class:`EncoderLayer` / :class:`DecoderLayer`
per layer and loops over them in Python, keeping the reference's names
(``enc_blocks``, ``dec_blocks``, ``self``, ``cross``, ``ln1``-``ln3``).

Every full-sequence attention goes through ``flash_attention``: per layer
pair one non-causal launch in the encoder, one causal (decoder self) and
one non-causal (cross, ``Sq`` prompt rows against ``Skv`` = frames keys)
in the decoder.  While gradients are recorded, ``encode`` and
``encdec_forward`` recompute activations in the backward pass under the
remat policy (``common.remat_layer``: by default each attention and MLP
on its own, keeping their outputs).

Serving: the cache keeps the reference's layout, ``{"self": {"k", "v"}}``
``(L, B, Hkv, max_len, Dh)`` and ``{"cross": {"k", "v"}}`` ``(L, B, Hkv,
frames, Dh)``.  ``encdec_prefill`` projects the cross K/V once per layer
from the encoder output, stores them and attends to the same projections;
``encdec_decode_step`` writes the new token's self K/V into its layer's
slice of the stacked cache in place and reads the cross cache, which stays
as prefill left it.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..dist.logical import constrain, current_mesh, replicate
from .common import (
    Attention,
    Embed,
    RMSNorm,
    SwiGLU,
    _decode_ctx,
    _param,
    _qkv,
    apply_rope,
    attend,
    attention_apply,
    attention_decode,
    attention_init,
    cast,
    chunked_xent,
    compute_dtype,
    dense_init,
    embed_apply,
    embed_init,
    last_token_logits,
    mlp_apply,
    mlp_init,
    pad_dim,
    remat_layer,
    remat_sublayer,
    rmsnorm_init,
    split_heads,
    tp_input,
    unembed_logits,
)

__all__ = [
    "DecoderLayer",
    "EncDec",
    "EncoderLayer",
    "encdec_cache_init",
    "encdec_decode_step",
    "encdec_forward",
    "encdec_loss",
    "encdec_prefill",
    "encode",
    "init_encdec",
]

Cache = Dict[str, Dict[str, torch.Tensor]]


class EncoderLayer(nn.Module):
    """``ln1`` → ``attn`` (bidirectional, no RoPE) → residual, ``ln2`` →
    ``mlp`` → residual."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class DecoderLayer(nn.Module):
    """``ln1`` → ``self`` (causal, RoPE) → residual, ``ln2`` → ``cross`` (to
    the encoder output) → residual, ``ln3`` → ``mlp`` → residual."""

    def __init__(self, ln1: RMSNorm, self_attn: Attention, ln2: RMSNorm,
                 cross: Attention, ln3: RMSNorm, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.ln2, self.ln3 = ln1, ln2, ln3
        self.self, self.cross, self.mlp = self_attn, cross, mlp


class EncDec(nn.Module):
    """Embeddings (untied unembedding), ``enc_pos (frames, D)``, the encoder
    blocks and ``enc_norm``, the decoder blocks and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, embed: Embed, enc_pos: torch.Tensor,
                 enc_blocks: List[EncoderLayer], enc_norm: RMSNorm,
                 dec_blocks: List[DecoderLayer], final_norm: RMSNorm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.enc_pos = _param(enc_pos)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = final_norm


def init_encdec(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> EncDec:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (which must live on ``device``) in the order embeddings,
    ``enc_pos`` (0.02 N(0, 1)), each encoder layer's attention and MLP,
    each decoder layer's self and cross attention and MLP; norms start at
    one.  The draws are torch's, not ``jax.random``'s."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")

    def norm():
        return RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps)

    embed = embed_init(cfg, generator)
    enc_pos = dense_init((cfg.enc_frames, cfg.d_model), generator,
                         scale=0.02).to(compute_dtype(cfg))
    enc = [EncoderLayer(norm(), attention_init(cfg, generator), norm(),
                        mlp_init(cfg, generator))
           for _ in range(cfg.n_enc_layers)]
    dec = [DecoderLayer(norm(), attention_init(cfg, generator), norm(),
                        attention_init(cfg, generator), norm(),
                        mlp_init(cfg, generator))
           for _ in range(cfg.n_layers)]
    return EncDec(cfg, embed, enc_pos, enc, norm(), dec, norm())


def _enc_attn(layer: EncoderLayer, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    return attention_apply(layer.attn, cfg, layer.ln1(x), positions, causal=False,
                           use_rope=False)


def _mlp(mlp: SwiGLU, ln: RMSNorm, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return mlp_apply(mlp, cfg, ln(x))


def _enc_layer(layer: EncoderLayer, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    x = x + remat_sublayer("attn_out", _enc_attn, layer, cfg, x, positions)
    return x + remat_sublayer("ffn_out", _mlp, layer.mlp, layer.ln2, cfg, x)


def encode(model: EncDec, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, F, D), the stub frontend's embeddings → the encoder
    output (B, F, D) in the compute dtype.  Each block runs under
    ``remat_layer``."""
    f = frames.shape[1]
    x = frames.to(compute_dtype(cfg)) + cast(model.enc_pos[:f], cfg)[None]
    positions = replicate(torch.arange(f, device=x.device)[None, :])
    for layer in model.enc_blocks:
        x = constrain(x, "batch", "seq_sp", None)
        x = remat_layer(_enc_layer, layer, cfg, x, positions)
    return model.enc_norm(x)


def _dec_self(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    return attention_apply(layer.self, cfg, layer.ln1(x), positions, causal=True)


def _dec_cross(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    return attention_apply(layer.cross, cfg, layer.ln2(x), positions, kv_from=enc_out)


def _dec_layer(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
    x = x + remat_sublayer("attn_out", _dec_self, layer, cfg, x, positions)
    x = x + remat_sublayer("attn_out", _dec_cross, layer, cfg, x, positions, enc_out)
    return x + remat_sublayer("ffn_out", _mlp, layer.mlp, layer.ln3, cfg, x)


def encdec_forward(model: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
    """→ the decoder's final hidden states (B, S, D).  Each block runs
    under ``remat_layer``."""
    enc_out = encode(model, cfg, frames)
    x = embed_apply(model.embed, cfg, tokens)
    positions = replicate(torch.arange(x.shape[1], device=x.device)[None, :])
    for layer in model.dec_blocks:
        x = constrain(x, "batch", "seq_sp", None)
        x = remat_layer(_dec_layer, layer, cfg, x, positions, enc_out)
    return constrain(model.final_norm(x), "batch", "seq", None)


def encdec_loss(model: EncDec, cfg: ModelConfig, frames: torch.Tensor,
                tokens: torch.Tensor, loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross entropy of the decoder → (loss, {"xent", "aux": 0})."""
    hidden = encdec_forward(model, cfg, frames, tokens)
    mask = None if loss_mask is None else loss_mask[:, 1:]
    xent = chunked_xent(model.embed, cfg, hidden[:, :-1], tokens[:, 1:], mask)
    return xent, {"xent": xent,
                  "aux": torch.zeros((), dtype=torch.float32, device=xent.device)}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _zeros_cache(cfg: ModelConfig, batch: int, max_len: int, frames: int,
                 dev: torch.device) -> Cache:
    hkv, dh, cdt, n = cfg.n_kv_heads, cfg.resolved_head_dim, compute_dtype(cfg), cfg.n_layers
    return {part: {name: torch.zeros((n, batch, hkv, rows, dh), dtype=cdt, device=dev)
                   for name in ("k", "v")}
            for part, rows in (("self", max_len), ("cross", frames))}


def encdec_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = "cuda") -> Cache:
    """Zeroed caches: ``self`` ``(L, B, Hkv, max_len, Dh)`` and ``cross``
    ``(L, B, Hkv, enc_frames, Dh)``."""
    return _zeros_cache(cfg, batch, max_len, cfg.enc_frames, resolve_device(device))


@torch.no_grad()
def encdec_prefill(
    model: EncDec,
    cfg: ModelConfig,
    frames: torch.Tensor,                    # (B, F, D)
    tokens: torch.Tensor,                    # (B, S)
    max_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,  # (B,) true prompt lengths
) -> Tuple[torch.Tensor, Cache]:
    """Encode, then the decoder over the prompt, building both caches →
    (logits at each sequence's last prompt position (B, V), cache).

    Per decoder layer: the causal self-attention's K/V go to the ``self``
    cache; the cross K/V are projected once from the encoder output, go to
    the ``cross`` cache, and the prompt's non-causal ``flash_attention``
    reads the same projections (no second projection, as in the
    reference)."""
    enc_out = encode(model, cfg, frames)
    x = embed_apply(model.embed, cfg, tokens)
    b, s, _ = x.shape
    f = enc_out.shape[1]
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    max_len = max(max_len or s, s)
    positions = replicate(torch.arange(s, device=x.device)[None, :])
    mesh = current_mesh()
    cache = _zeros_cache(cfg, b, max_len, f, x.device) if mesh is None else None
    rows = {(part, name): [] for part in ("self", "cross") for name in ("k", "v")}

    def keep(part: str, i: int, kt: torch.Tensor, vt: torch.Tensor) -> None:
        if cache is not None:     # written in place into the caches made once
            cache[part]["k"][i, :, :, :kt.shape[2]] = kt
            cache[part]["v"][i, :, :, :vt.shape[2]] = vt
        else:   # DTensor rows, each padded to its cache's length, stacked below
            pad = (max_len if part == "self" else f) - kt.shape[2]
            rows[part, "k"].append(pad_dim(kt, 2, 0, pad))
            rows[part, "v"].append(pad_dim(vt, 2, 0, pad))

    for i, layer in enumerate(model.dec_blocks):
        q, k, v = _qkv(layer.self, cfg, layer.ln1(x))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc, vc = k.transpose(1, 2), v.transpose(1, 2)    # (B, Hkv, S, Dh) views
        keep("self", i, kc, vc)
        att = attend(q.transpose(1, 2), kc, vc, causal=True)
        x = x + att.transpose(1, 2).reshape(b, s, -1) @ cast(layer.self.wo, cfg)

        cross = layer.cross
        qx = tp_input(layer.ln2(x)) @ cast(cross.wq, cfg)
        kx = tp_input(enc_out) @ cast(cross.wk, cfg)
        vx = tp_input(enc_out) @ cast(cross.wv, cfg)
        if cfg.qkv_bias:
            qx = qx + cast(cross.bq, cfg)
            kx = kx + cast(cross.bk, cfg)
            vx = vx + cast(cross.bv, cfg)
        kx = split_heads(kx, hkv, dh).transpose(1, 2)     # (B, Hkv, F, Dh) views
        vx = split_heads(vx, hkv, dh).transpose(1, 2)
        keep("cross", i, kx, vx)
        att = attend(split_heads(qx, h, dh).transpose(1, 2), kx, vx, causal=False)
        x = x + att.transpose(1, 2).reshape(b, s, -1) @ cast(cross.wo, cfg)
        x = x + mlp_apply(layer.mlp, cfg, layer.ln3(x))
    x = model.final_norm(x)
    if cache is None:
        cdt = compute_dtype(cfg)
        cache = {part: {name: torch.stack(rows[part, name]).to(cdt)
                        for name in ("k", "v")} for part in ("self", "cross")}
    return last_token_logits(model.embed, cfg, x, lengths), cache


def _cross_decode(attn: Attention, cfg: ModelConfig, x: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One token's cross attention, x (B, 1, D), against the static cross
    cache k, v (B, Hkv, F, Dh) (every frame visible): the grouped products
    with float32 scores and a float32 context, cast before ``wo``."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q = x[:, 0] @ cast(attn.wq, cfg)
    if cfg.qkv_bias:
        q = q + cast(attn.bq, cfg)
    ctx = _decode_ctx(split_heads(q, h, dh), k, v)
    ctx = ctx.to(compute_dtype(cfg))
    return (ctx @ cast(attn.wo, cfg))[:, None, :]


@torch.no_grad()
def encdec_decode_step(
    model: EncDec,
    cfg: ModelConfig,
    token: torch.Tensor,     # (B, 1) token ids
    pos: torch.Tensor,       # (B,) absolute position of `token`
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through every decoder layer → (logits (B, V),
    cache); the ``self`` cache is updated in place and returned."""
    x = embed_apply(model.embed, cfg, token)
    self_kv, cross_kv = cache["self"], cache["cross"]
    for i, layer in enumerate(model.dec_blocks):
        kv = {"k": self_kv["k"][i], "v": self_kv["v"][i]}  # views: written in place
        att, kv = attention_decode(layer.self, cfg, layer.ln1(x), pos, kv)
        x = x + att
        x = x + _cross_decode(layer.cross, cfg, layer.ln2(x), cross_kv["k"][i],
                              cross_kv["v"][i])
        x = x + mlp_apply(layer.mlp, cfg, layer.ln3(x))
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], cache
