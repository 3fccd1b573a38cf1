"""Pure SSM LM of the port (the mamba2 family), the counterpart of the
reference's ``models/ssm.py``.

Block = RMSNorm → Mamba2 mixer → residual (no separate MLP, per the
published architecture).  The reference scans stacked weights; the port
holds one :class:`SSMLayer` per layer and loops over them in Python.

The cache is a list with one ``{"ssm", "conv"}`` dict per layer:
``ssm (B, H, P, N)`` float32 and ``conv (B, K-1, conv_dim)`` in the
compute dtype (the reference stacks the same arrays per layer).  Decode
needs no positions: the state is O(1) in the sequence length.
``ssm_loss`` is the training loss; while gradients are recorded,
``ssm_forward`` recomputes each layer's mixer in the backward pass (under
either remat policy, ``common.remat_layer``: the layer is its mixer), so a
step runs ``ssd_scan`` three times a layer: forward, recompute and the
scan's own backward.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..dist.logical import constrain
from .common import (
    Embed,
    RMSNorm,
    chunked_xent,
    compute_dtype,
    embed_apply,
    embed_init,
    last_token_logits,
    remat_layer,
    remat_sublayer,
    rmsnorm_init,
    unembed_logits,
)
from .mamba2 import Mamba2, mamba_apply, mamba_decode, mamba_init, mamba_state_init

__all__ = [
    "SSM",
    "SSMLayer",
    "init_ssm",
    "ssm_cache_init",
    "ssm_decode_step",
    "ssm_forward",
    "ssm_loss",
    "ssm_prefill",
]

Cache = List[Dict[str, torch.Tensor]]


class SSMLayer(nn.Module):
    def __init__(self, ln: RMSNorm, mamba: Mamba2):
        super().__init__()
        self.ln, self.mamba = ln, mamba


class SSM(nn.Module):
    """Embeddings, one :class:`SSMLayer` per layer, final norm."""

    def __init__(self, cfg: ModelConfig, embed: Embed, layers: List[SSMLayer],
                 final_norm: RMSNorm):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm


def init_ssm(cfg: ModelConfig, generator: torch.Generator,
             device: DeviceLike = "cuda") -> SSM:
    """Random weights with the reference's distributions, drawn from
    ``generator`` (which must live on ``device``): embeddings, then each
    layer's mixer; norms start at one."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    embed = embed_init(cfg, generator)
    layers = [SSMLayer(RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps),
                       mamba_init(cfg, generator))
              for _ in range(cfg.n_layers)]
    return SSM(cfg, embed, layers,
               RMSNorm(rmsnorm_init(cfg.d_model, dev), cfg.norm_eps))


def _mixer_sublayer(layer: SSMLayer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return mamba_apply(layer.mamba, cfg, layer.ln(x))


def _layer_forward(layer: SSMLayer, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return x + remat_sublayer("mixer_out", _mixer_sublayer, layer, cfg, x)


def ssm_forward(model: SSM, cfg: ModelConfig,
                tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (hidden (B, S, D), aux_loss scalar 0).  Each layer runs under
    ``remat_layer``."""
    x = embed_apply(model.embed, cfg, tokens)
    for layer in model.layers:
        x = constrain(x, "batch", "seq_sp", None)
        x = remat_layer(_layer_forward, layer, cfg, x)
    return (constrain(model.final_norm(x), "batch", "seq", None),
            torch.zeros((), dtype=torch.float32, device=x.device))


def ssm_loss(model: SSM, cfg: ModelConfig, tokens: torch.Tensor,
             loss_mask: Optional[torch.Tensor] = None):
    """Next-token cross entropy → (loss, {"xent", "aux": 0})."""
    hidden, aux = ssm_forward(model, cfg, tokens)
    mask = None if loss_mask is None else loss_mask[:, 1:]
    xent = chunked_xent(model.embed, cfg, hidden[:, :-1], tokens[:, 1:], mask)
    return xent, {"xent": xent, "aux": aux}


def ssm_cache_init(cfg: ModelConfig, batch: int, max_len: int = 0,
                   device: DeviceLike = "cuda") -> Cache:
    """Zeroed per-layer recurrent states (``max_len`` is not needed)."""
    dev = resolve_device(device)
    return [mamba_state_init(cfg, batch, compute_dtype(cfg), dev)
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def ssm_prefill(model: SSM, cfg: ModelConfig, tokens: torch.Tensor,
                max_len: Optional[int] = None,
                lengths: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also builds the recurrent cache →
    (last-token logits (B, V), cache).  ``lengths`` picks each sequence's
    true last prompt position for the logits; the states are built over
    the padded batch, as the reference builds them.  One ``ssd_scan`` call
    per layer."""
    x = embed_apply(model.embed, cfg, tokens)
    cache: Cache = []
    for layer in model.layers:
        y, st = mamba_apply(layer.mamba, cfg, layer.ln(x), return_state=True)
        x = x + y
        cache.append(st)
    x = model.final_norm(x)
    return last_token_logits(model.embed, cfg, x, lengths), cache


@torch.no_grad()
def ssm_decode_step(model: SSM, cfg: ModelConfig, token: torch.Tensor,
                    pos: torch.Tensor, cache: Cache) -> Tuple[torch.Tensor, Cache]:
    """One-token decode → (logits (B, V), new cache); ``pos`` is unused
    (the uniform API passes it)."""
    x = embed_apply(model.embed, cfg, token)
    new_cache: Cache = []
    for layer, st in zip(model.layers, cache):
        y, st = mamba_decode(layer.mamba, cfg, layer.ln(x), st)
        x = x + y
        new_cache.append(st)
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], new_cache
