"""Decoder-only LM of the port: the dense, local/global (gemma3) and VLM
families of the reference's ``models/transformer.py``.

The reference scans stacked weights (one scan step per layer, or per block
of ``local_block`` layers for gemma3); the port holds one
:class:`DecoderLayer` per layer in an ``nn.ModuleList`` and loops over them
in Python.  Layer ``i`` takes the window ``layer_windows(cfg)[i % per]``.

Entry points: ``init_lm``, ``lm_forward``, ``lm_cache_init``, ``lm_prefill``
(forward + KV cache build) and ``lm_decode_step`` (one-token serve).  The
cache is a list with one ``{"k", "v"}`` dict per layer, each ``(B, Hkv,
slots, Dh)``; the reference stacks the same arrays per scan position.
MoE decoder layers, the paged cache and training are later slices
(ROADMAP).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..kernels.flash_attention.ops import flash_attention
from .common import (
    Attention,
    Embed,
    RMSNorm,
    SwiGLU,
    _qkv,
    apply_rope,
    attention_apply,
    attention_decode,
    attention_init,
    compute_dtype,
    embed_apply,
    embed_init,
    last_token_logits,
    mlp_apply,
    mlp_init,
    rmsnorm_init,
    unembed_logits,
)

__all__ = [
    "DecoderLayer",
    "LM",
    "init_lm",
    "layer_windows",
    "lm_cache_init",
    "lm_decode_step",
    "lm_forward",
    "lm_prefill",
]

Cache = List[Dict[str, torch.Tensor]]


def _n_scan(cfg: ModelConfig) -> Tuple[int, int]:
    """(number of scan steps, layers per step) of the reference's stack."""
    if cfg.local_block:
        if cfg.n_layers % cfg.local_block:
            raise ValueError(
                f"{cfg.n_layers} layers do not split into blocks of {cfg.local_block}"
            )
        return cfg.n_layers // cfg.local_block, cfg.local_block
    return cfg.n_layers, 1


def layer_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Window (or None) per sub-layer position within one scan step."""
    _, per = _n_scan(cfg)
    if cfg.local_block:
        # gemma3: positions 0..per-2 local (sliding window), the last global
        return [cfg.window] * (per - 1) + [None]
    return [cfg.window] * per


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.n_experts > 0 and cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the transformer's MoE layers are not wired yet "
            "(ROADMAP Queue 1 item 5b: models/moe.py's moe_apply in "
            "DecoderLayer)"
        )


class DecoderLayer(nn.Module):
    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm, mlp: SwiGLU):
        super().__init__()
        self.ln1, self.attn, self.ln2, self.mlp = ln1, attn, ln2, mlp


class LM(nn.Module):
    """Embeddings, one :class:`DecoderLayer` per layer, final norm."""

    def __init__(self, cfg: ModelConfig, embed: Embed,
                 layers: List[DecoderLayer], final_norm: RMSNorm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm

    def windows(self) -> List[Optional[int]]:
        """The window (or None) of every layer."""
        w = layer_windows(self.cfg)
        return [w[i % len(w)] for i in range(len(self.layers))]


def init_lm(cfg: ModelConfig, generator: torch.Generator,
            device: DeviceLike = "cuda") -> LM:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (which must live on ``device``) in the order embeddings,
    then each layer's attention and MLP; norms start at one.  The draws are
    torch's, not ``jax.random``'s: the same seed gives other numbers."""
    _require_dense(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    eps = cfg.norm_eps
    embed = embed_init(cfg, generator)
    layers = []
    for _ in range(cfg.n_layers):
        attn = attention_init(cfg, generator)
        mlp = mlp_init(cfg, generator)
        layers.append(DecoderLayer(RMSNorm(rmsnorm_init(cfg.d_model, dev), eps),
                                   attn,
                                   RMSNorm(rmsnorm_init(cfg.d_model, dev), eps),
                                   mlp))
    return LM(cfg, embed, layers, RMSNorm(rmsnorm_init(cfg.d_model, dev), eps))


def _embed_inputs(model: LM, cfg: ModelConfig, tokens, extra_embeds):
    x = embed_apply(model.embed, cfg, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def lm_forward(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,                          # (B, S_txt)
    extra_embeds: Optional[torch.Tensor] = None,   # (B, I, D) VLM patch embeds
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (hidden (B, S, D), aux_loss scalar)."""
    _require_dense(cfg)
    x = _embed_inputs(model, cfg, tokens, extra_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for layer, window in zip(model.layers, model.windows()):
        h = layer.ln1(x)
        x = x + attention_apply(layer.attn, cfg, h, positions, causal=True,
                                window=window)
        x = x + mlp_apply(layer.mlp, cfg, layer.ln2(x))
    return model.final_norm(x), torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def _slot_count(window: Optional[int], max_len: int) -> int:
    return min(window, max_len) if window is not None else max_len


def lm_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                  device: DeviceLike = "cuda") -> Cache:
    """Zeroed per-layer KV caches: ``max_len`` slots, or ``min(window,
    max_len)`` ring slots on a window layer."""
    dev = resolve_device(device)
    hkv, dh, cdt = cfg.n_kv_heads, cfg.resolved_head_dim, compute_dtype(cfg)
    w = layer_windows(cfg)
    cache = []
    for i in range(cfg.n_layers):
        shape = (batch, hkv, _slot_count(w[i % len(w)], max_len), dh)
        cache.append({"k": torch.zeros(shape, dtype=cdt, device=dev),
                      "v": torch.zeros(shape, dtype=cdt, device=dev)})
    return cache


@torch.no_grad()
def lm_prefill(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    extra_embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
    lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the KV cache.

    Returns (last-token logits (B, V), cache).  Window layers keep only the
    trailing ``window`` keys (ring layout, slot = pos % window).
    ``lengths`` (B,) gathers each sequence's true last-prompt-position
    logits, so right-padded ragged batches do not read a pad row.  One
    ``flash_attention`` call per layer.
    """
    _require_dense(cfg)
    cdt = compute_dtype(cfg)
    x = _embed_inputs(model, cfg, tokens, extra_embeds)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    positions = torch.arange(s, device=x.device)[None, :]
    cache: Cache = []
    for layer, window in zip(model.layers, model.windows()):
        h = layer.ln1(x)
        q, k, v = _qkv(layer.attn, cfg, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kc = k.transpose(1, 2)                   # (B, Hkv, S, Dh) views
        vc = v.transpose(1, 2)
        if window is not None and s >= window:
            # ring layout: slot = pos % window over the last `window` tokens
            kv = {"k": torch.roll(kc[:, :, s - window:], s % window, 2).to(cdt),
                  "v": torch.roll(vc[:, :, s - window:], s % window, 2).to(cdt)}
        else:
            slots = _slot_count(window, max_len)
            kv = {}
            for name, t in (("k", kc), ("v", vc)):
                buf = torch.zeros((b, t.shape[1], slots, t.shape[3]), dtype=cdt,
                                  device=x.device)
                buf[:, :, :s] = t
                kv[name] = buf
        cache.append(kv)
        attn = flash_attention(q.transpose(1, 2), kc, vc, causal=True,
                               window=window)
        x = x + attn.transpose(1, 2).reshape(b, s, -1) @ layer.attn.wo
        x = x + mlp_apply(layer.mlp, cfg, layer.ln2(x))
    x = model.final_norm(x)
    offset = extra_embeds.shape[1] if extra_embeds is not None else 0
    return last_token_logits(model.embed, cfg, x, lengths, offset), cache


@torch.no_grad()
def lm_decode_step(
    model: LM,
    cfg: ModelConfig,
    token: torch.Tensor,     # (B, 1) token ids
    pos: torch.Tensor,       # (B,) absolute position of `token`
    cache: Cache,
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode through every layer → (logits (B, V), cache); the
    cache is updated in place and returned."""
    x = embed_apply(model.embed, cfg, token)
    for layer, window, kv in zip(model.layers, model.windows(), cache):
        attn, _ = attention_decode(layer.attn, cfg, layer.ln1(x), pos, kv,
                                   window=window)
        x = x + attn
        x = x + mlp_apply(layer.mlp, cfg, layer.ln2(x))
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], cache
