"""Hybrid SSM + attention LM of the port (the Jamba family), the
counterpart of the reference's ``models/hybrid.py``.

A super-block of ``hybrid_block`` layers repeats ``n_layers /
hybrid_block`` times: position ``attn_index`` is GQA attention, the others
are Mamba2 SSD mixers; the FFN is a MoE layer at every ``moe_every``-th
position and a dense SwiGLU elsewhere (:func:`_layout`).  The reference
stacks the weights twice (super-block, then position inside it) and scans
the super-blocks; the port holds one :class:`HybridLayer` per layer, layer
``block * hybrid_block + j`` at position ``j``, and loops in Python.

The cache is a list with one dict per layer: ``{"k", "v"}`` ``(B, Hkv,
max_len, Dh)`` at the attention position, ``{"ssm", "conv"}`` at a Mamba
position.  Prefill runs ``flash_attention`` once per super-block and
``ssd_scan`` once per Mamba position; MoE drops tokens over capacity in
prefill and never in decode, as in the reference.  ``hybrid_loss`` is
the training loss; while gradients are recorded, ``hybrid_forward``
recomputes each layer in the backward pass (``common.remat``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from .. import flags
from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..dist.logical import constrain, replicate
from .common import (
    Attention,
    Embed,
    RMSNorm,
    SwiGLU,
    _qkv,
    apply_rope,
    attend,
    attention_apply,
    attention_decode,
    attention_init,
    cast,
    chunked_xent,
    compute_dtype,
    embed_apply,
    embed_init,
    last_token_logits,
    mlp_apply,
    mlp_init,
    pad_dim,
    remat,
    rmsnorm_init,
    unembed_logits,
)
from .mamba2 import Mamba2, mamba_apply, mamba_decode, mamba_init, mamba_state_init
from .moe import MoE, moe_apply, moe_init

__all__ = [
    "Hybrid",
    "HybridLayer",
    "hybrid_cache_init",
    "hybrid_decode_step",
    "hybrid_forward",
    "hybrid_loss",
    "hybrid_prefill",
    "init_hybrid",
]

Cache = List[Dict[str, torch.Tensor]]


def _layout(cfg: ModelConfig):
    """(n_blocks, per, mamba positions, moe positions, mlp positions)."""
    per = cfg.hybrid_block
    if per <= 0 or cfg.n_layers % per:
        raise ValueError(
            f"{cfg.n_layers} layers do not split into super-blocks of {per}"
        )
    n_blocks = cfg.n_layers // per
    mamba_pos = [j for j in range(per) if j != cfg.attn_index]
    moe_pos = [j for j in range(per) if j % cfg.moe_every == cfg.moe_every - 1]
    mlp_pos = [j for j in range(per) if j not in moe_pos]
    return n_blocks, per, mamba_pos, moe_pos, mlp_pos


class HybridLayer(nn.Module):
    """``ln_mix`` → ``mixer`` (attention or Mamba2) → residual, ``ln_ffn``
    → ``ffn`` (MoE or SwiGLU) → residual."""

    def __init__(self, ln_mix: RMSNorm, mixer: Union[Attention, Mamba2],
                 ln_ffn: RMSNorm, ffn: Union[MoE, SwiGLU]):
        super().__init__()
        self.ln_mix, self.mixer, self.ln_ffn, self.ffn = ln_mix, mixer, ln_ffn, ffn


class Hybrid(nn.Module):
    """Embeddings, one :class:`HybridLayer` per layer, final norm."""

    def __init__(self, cfg: ModelConfig, embed: Embed, layers: List[HybridLayer],
                 final_norm: RMSNorm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_hybrid(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = "cuda") -> Hybrid:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (which must live on ``device``): embeddings, then each
    layer's mixer and FFN in layer order; norms start at one."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    _, per, _, moe_pos, _ = _layout(cfg)
    embed = embed_init(cfg, generator)
    layers = []
    for i in range(cfg.n_layers):
        j = i % per
        mixer = (attention_init(cfg, generator) if j == cfg.attn_index
                 else mamba_init(cfg, generator))
        ffn = moe_init(cfg, generator) if j in moe_pos else mlp_init(cfg, generator)
        layers.append(HybridLayer(RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps),
                                  mixer,
                                  RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps),
                                  ffn))
    return Hybrid(cfg, embed, layers,
                  RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps))


def _ffn(layer: HybridLayer, cfg: ModelConfig, x: torch.Tensor,
         no_drop: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN on ``ln_ffn(x)`` → (y, aux loss)."""
    h = layer.ln_ffn(x)
    if isinstance(layer.ffn, MoE):
        return moe_apply(layer.ffn, cfg, h, no_drop=no_drop)
    return mlp_apply(layer.ffn, cfg, h), torch.zeros((), device=x.device)


def _layer_forward(layer: HybridLayer, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor):
    """One layer → (x, its FFN's aux loss)."""
    h = layer.ln_mix(x)
    if isinstance(layer.mixer, Attention):
        x = x + attention_apply(layer.mixer, cfg, h, positions, causal=True)
    else:
        x = x + mamba_apply(layer.mixer, cfg, h)
    y, a = _ffn(layer, cfg, x)
    return x + y, a


def hybrid_forward(model: Hybrid, cfg: ModelConfig,
                   tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (hidden (B, S, D), summed MoE aux loss).  Each layer runs under
    ``remat``."""
    x = embed_apply(model.embed, cfg, tokens)
    positions = replicate(torch.arange(x.shape[1], device=x.device)[None, :])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per = _layout(cfg)[1]
    for i, layer in enumerate(model.layers):
        if i % per == 0:     # the reference's scan step: one hybrid block
            x = constrain(x, "batch", "seq_sp", None)
        x, a = remat(_layer_forward, layer, cfg, x, positions)
        aux = aux + a
    return constrain(model.final_norm(x), "batch", "seq", None), aux


def hybrid_loss(model: Hybrid, cfg: ModelConfig, tokens: torch.Tensor,
                loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross entropy + ``router_aux_coef`` x the MoE aux loss →
    (loss, {"xent", "aux"})."""
    hidden, aux = hybrid_forward(model, cfg, tokens)
    mask = None if loss_mask is None else loss_mask[:, 1:]
    xent = chunked_xent(model.embed, cfg, hidden[:, :-1], tokens[:, 1:], mask)
    return xent + cfg.router_aux_coef * aux, {"xent": xent, "aux": aux}


def hybrid_cache_init(cfg: ModelConfig, batch: int, max_len: int,
                      device: DeviceLike = "cuda") -> Cache:
    """Zeroed per-layer caches: KV of ``max_len`` slots at the attention
    position, recurrent states elsewhere."""
    dev = resolve_device(device)
    _, per, *_ = _layout(cfg)
    cdt = compute_dtype(cfg)
    shape = (batch, cfg.n_kv_heads, max_len, cfg.resolved_head_dim)
    return [
        {"k": torch.zeros(shape, dtype=cdt, device=dev),
         "v": torch.zeros(shape, dtype=cdt, device=dev)}
        if i % per == cfg.attn_index else mamba_state_init(cfg, batch, cdt, dev)
        for i in range(cfg.n_layers)
    ]


@torch.no_grad()
def hybrid_prefill(model: Hybrid, cfg: ModelConfig, tokens: torch.Tensor,
                   max_len: Optional[int] = None,
                   lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """Forward + cache build → (last-token logits (B, V), cache); the
    attention KV is padded to ``max_len`` slots."""
    cdt = compute_dtype(cfg)
    x = embed_apply(model.embed, cfg, tokens)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    positions = replicate(torch.arange(s, device=x.device)[None, :])
    cache: Cache = []
    for layer in model.layers:
        h = layer.ln_mix(x)
        if isinstance(layer.mixer, Attention):
            q, k, v = _qkv(layer.mixer, cfg, h)
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
            kc, vc = k.transpose(1, 2), v.transpose(1, 2)   # (B, Hkv, S, Dh)
            cache.append({"k": pad_dim(kc, 2, 0, max_len - s).to(cdt),
                          "v": pad_dim(vc, 2, 0, max_len - s).to(cdt)})
            att = attend(q.transpose(1, 2), kc, vc, causal=True)
            x = x + constrain(att.transpose(1, 2).reshape(b, s, -1)
                              @ cast(layer.mixer.wo, cfg), *flags.residual_axes())
        else:
            y, st = mamba_apply(layer.mixer, cfg, h, return_state=True)
            x = x + y
            cache.append(st)
        y, _ = _ffn(layer, cfg, x)
        x = x + y
    x = model.final_norm(x)
    return last_token_logits(model.embed, cfg, x, lengths), cache


@torch.no_grad()
def hybrid_decode_step(model: Hybrid, cfg: ModelConfig, token: torch.Tensor,
                       pos: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One-token decode.  token (B, 1), pos (B,) → (logits (B, V), cache):
    the KV caches are updated in place, the recurrent states replaced."""
    x = embed_apply(model.embed, cfg, token)
    new_cache: Cache = []
    for layer, st in zip(model.layers, cache):
        h = layer.ln_mix(x)
        if isinstance(layer.mixer, Attention):
            att, st = attention_decode(layer.mixer, cfg, h, pos, st)
            x = x + att
        else:
            y, st = mamba_decode(layer.mixer, cfg, h, st)
            x = x + y
        new_cache.append(st)
        y, _ = _ffn(layer, cfg, x, no_drop=True)
        x = x + y
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], new_cache
