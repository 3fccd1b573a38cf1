"""Decoder-only LM of the port: the dense, local/global (gemma3), MoE and
VLM families of the reference's ``models/transformer.py``.

The reference scans stacked weights (one scan step per layer, or per block
of ``local_block`` layers for gemma3); the port holds one
:class:`DecoderLayer` per layer in an ``nn.ModuleList`` and loops over them
in Python.  Layer ``i`` takes the window ``layer_windows(cfg)[i % per]``.

A layer's FFN is a SwiGLU, or on the MoE family (``_is_moe_layer``) a
:class:`~.moe.MoE`: ``lm_forward`` and ``lm_prefill`` route with capacity
drops and ``lm_decode_step`` with ``no_drop=True``, as the reference does;
``lm_forward`` sums the router's aux loss over the layers.

Entry points: ``init_lm``, ``lm_forward``, ``lm_loss`` (next-token cross
entropy plus the router's aux loss: training), ``lm_cache_init``,
``lm_prefill`` (forward + KV cache build) and ``lm_decode_step``
(one-token serve).  While gradients are recorded, ``lm_forward``
recomputes activations in the backward pass under the remat policy
(``common.remat_layer``: by default each layer's attention and FFN on
their own, keeping their outputs).  The
cache is a list with one ``{"k", "v"}`` dict per layer, each ``(B, Hkv,
slots, Dh)``; the reference stacks the same arrays per scan position.

The paged cache of continuous batching (global-attention stacks only):
``lm_paged_cache_init`` (one ``(Hkv, n_blocks * bs, Dh)`` pool per layer,
block 0 the trash block), ``lm_decode_step_paged``,
``lm_paged_prefill_write`` and ``lm_prefill_suffix``, which prefills a
prompt's suffix against adopted prefix blocks.  They update the pools in
place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn


from .. import flags
from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..dist.logical import constrain, replicate
from ..kernels.flash_attention.ops import flash_attention
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
    attention_decode_paged,
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
    paged_view,
    paged_write_rows,
    remat_layer,
    remat_sublayer,
    rmsnorm_init,
    unembed_logits,
)
from .moe import MoE, moe_apply, moe_init

__all__ = [
    "DecoderLayer",
    "LM",
    "init_lm",
    "layer_windows",
    "lm_cache_init",
    "lm_decode_step",
    "lm_decode_step_paged",
    "lm_forward",
    "lm_loss",
    "lm_paged_cache_init",
    "lm_paged_prefill_write",
    "lm_prefill",
    "lm_prefill_suffix",
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


def _is_moe_layer(cfg: ModelConfig) -> bool:
    return cfg.n_experts > 0 and cfg.family in ("moe",)


class DecoderLayer(nn.Module):
    """``ln1`` → ``attn`` → residual, ``ln2`` → the FFN (``mlp``, a SwiGLU,
    or ``moe`` on an MoE layer; the other is None) → residual."""

    def __init__(self, ln1: RMSNorm, attn: Attention, ln2: RMSNorm,
                 mlp: Optional[SwiGLU] = None, moe: Optional[MoE] = None):
        super().__init__()
        if (mlp is None) == (moe is None):
            raise ValueError("a decoder layer takes one of mlp and moe")
        self.ln1, self.attn, self.ln2, self.mlp, self.moe = ln1, attn, ln2, mlp, moe


def _ffn(layer: DecoderLayer, cfg: ModelConfig, h: torch.Tensor,
         no_drop: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN of ``h`` → (y, the router's aux loss or None)."""
    if layer.moe is not None:
        return moe_apply(layer.moe, cfg, h, no_drop=no_drop)
    return mlp_apply(layer.mlp, cfg, h), None


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
    then each layer's attention and MLP (or MoE); norms start at one.  Each
    matrix is drawn in float32 and cast to the compute dtype on its own, so
    the float32 copy of one tensor at a time is all the draw adds.  The
    draws are torch's, not ``jax.random``'s: the same seed gives other
    numbers."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, weights on {dev}")
    eps = cfg.norm_eps
    embed = embed_init(cfg, generator)
    layers = []
    for _ in range(cfg.n_layers):
        attn = attention_init(cfg, generator)
        ffn = (dict(moe=moe_init(cfg, generator)) if _is_moe_layer(cfg)
               else dict(mlp=mlp_init(cfg, generator)))
        layers.append(DecoderLayer(RMSNorm(rmsnorm_init(cfg.d_model, dev), eps),
                                   attn,
                                   RMSNorm(rmsnorm_init(cfg.d_model, dev), eps),
                                   **ffn))
    return LM(cfg, embed, layers, RMSNorm(rmsnorm_init(cfg.d_model, dev), eps))


def _embed_inputs(model: LM, cfg: ModelConfig, tokens, extra_embeds):
    x = embed_apply(model.embed, cfg, tokens)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    return x


def _attn_sublayer(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    return attention_apply(layer.attn, cfg, layer.ln1(x), positions, causal=True,
                           window=window)


def _ffn_sublayer(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor):
    y, a = _ffn(layer, cfg, layer.ln2(x))
    if a is None:
        a = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, a


def _layer_forward(layer: DecoderLayer, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int]):
    """One layer → (x, its router aux loss, 0 without a router)."""
    x = x + remat_sublayer("attn_out", _attn_sublayer, layer, cfg, x, positions,
                           window)
    y, a = remat_sublayer("ffn_out", _ffn_sublayer, layer, cfg, x)
    return x + y, a


def lm_forward(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,                          # (B, S_txt)
    extra_embeds: Optional[torch.Tensor] = None,   # (B, I, D) VLM patch embeds
) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (hidden (B, S, D), aux_loss scalar: the routers' summed over the
    MoE layers, 0 without one).  Each layer runs under ``remat_layer``."""
    x = _embed_inputs(model, cfg, tokens, extra_embeds)
    positions = replicate(torch.arange(x.shape[1], device=x.device)[None, :])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per = len(layer_windows(cfg))
    for i, (layer, window) in enumerate(zip(model.layers, model.windows())):
        if i % per == 0:     # the reference's scan step: a block of `per` layers
            x = constrain(x, "batch", "seq_sp", None)
        x, a = remat_layer(_layer_forward, layer, cfg, x, positions, window)
        aux = aux + a
        if (i + 1) % per == 0:
            x = constrain(x, "batch", "seq_sp", None)
    return constrain(model.final_norm(x), "batch", "seq", None), aux


def lm_loss(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,                          # (B, S_txt)
    loss_mask: Optional[torch.Tensor] = None,      # (B, S_txt)
    extra_embeds: Optional[torch.Tensor] = None,   # (B, I, D)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy + ``router_aux_coef`` x the router aux loss
    → (loss, {"xent", "aux"}).  With ``I`` prepended patch embeddings,
    hidden rows ``I-1 .. I+T-2`` predict tokens ``0 .. T-1``."""
    hidden, aux = lm_forward(model, cfg, tokens, extra_embeds)
    n_img = 0 if extra_embeds is None else extra_embeds.shape[1]
    t = tokens.shape[1]
    if n_img:
        pred = hidden[:, n_img - 1:n_img - 1 + t]
        targets, mask = tokens, loss_mask
    else:
        pred = hidden[:, :-1]
        targets = tokens[:, 1:]
        mask = None if loss_mask is None else loss_mask[:, 1:]
    xent = chunked_xent(model.embed, cfg, pred, targets, mask)
    loss = xent + cfg.router_aux_coef * aux
    return loss, {"xent": xent, "aux": aux}


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
    ``flash_attention`` call per layer; MoE layers drop assignments over
    capacity, counted over the whole padded batch.
    """
    cdt = compute_dtype(cfg)
    x = _embed_inputs(model, cfg, tokens, extra_embeds)
    b, s, _ = x.shape
    max_len = max(max_len or s, s)
    positions = replicate(torch.arange(s, device=x.device)[None, :])
    cache: Cache = []
    per = len(layer_windows(cfg))
    for i, (layer, window) in enumerate(zip(model.layers, model.windows())):
        if i % per == 0:
            x = constrain(x, "batch", "seq_sp", None)
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
            pad = _slot_count(window, max_len) - s
            kv = {"k": pad_dim(kc, 2, 0, pad).to(cdt), "v": pad_dim(vc, 2, 0, pad).to(cdt)}
        cache.append(kv)
        attn = attend(q.transpose(1, 2), kc, vc, causal=True, window=window)
        x = x + constrain(attn.transpose(1, 2).reshape(b, s, -1)
                          @ cast(layer.attn.wo, cfg), *flags.residual_axes())
        x = x + _ffn(layer, cfg, layer.ln2(x))[0]
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
        x = x + _ffn(layer, cfg, layer.ln2(x), no_drop=True)[0]
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], cache


# ---------------------------------------------------------------------------
# serving: the paged (block) KV cache
# ---------------------------------------------------------------------------

def _require_no_windows(cfg: ModelConfig) -> None:
    if any(w is not None for w in layer_windows(cfg)):
        raise NotImplementedError(
            "paged KV cache covers global-attention layers only; "
            f"{cfg.name} has sliding-window layers (window={cfg.window}, "
            f"local_block={cfg.local_block}) — serve it with the static "
            "engine, or page only the global layers (open follow-up)"
        )


def lm_paged_cache_init(cfg: ModelConfig, n_blocks: int, block_size: int,
                        device: DeviceLike = "cuda") -> Cache:
    """One zeroed block pool per layer, ``{"k", "v"}`` each ``(Hkv, n_blocks
    * block_size, Dh)``: block i owns rows [i*bs, (i+1)*bs) and block 0 is
    the trash block (``serve.kvcache``).  No batch dimension: slots share
    the pool through their block tables."""
    _require_no_windows(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_kv_heads, n_blocks * block_size, cfg.resolved_head_dim)
    cdt = compute_dtype(cfg)
    return [{"k": torch.zeros(shape, dtype=cdt, device=dev),
             "v": torch.zeros(shape, dtype=cdt, device=dev)}
            for _ in range(cfg.n_layers)]


@torch.no_grad()
def lm_decode_step_paged(
    model: LM,
    cfg: ModelConfig,
    token: torch.Tensor,     # (B, 1) token ids
    pos: torch.Tensor,       # (B,) absolute position of `token`
    tables: torch.Tensor,    # (B, M) per-slot block tables
    cache: Cache,            # lm_paged_cache_init layout
    block_size: int,
) -> Tuple[torch.Tensor, Cache]:
    """One-token decode against the shared block pools → (logits (B, V),
    cache); the pools are updated in place and returned."""
    _require_no_windows(cfg)
    x = embed_apply(model.embed, cfg, token)
    for layer, kv in zip(model.layers, cache):
        attn, _ = attention_decode_paged(layer.attn, cfg, layer.ln1(x), pos, kv,
                                         tables, block_size)
        x = x + attn
        x = x + _ffn(layer, cfg, layer.ln2(x), no_drop=True)[0]
    x = model.final_norm(x)
    return unembed_logits(model.embed, cfg, x)[:, 0], cache


def lm_paged_prefill_write(
    cfg: ModelConfig,
    cache: Cache,            # lm_paged_cache_init layout
    prefill_cache: Cache,    # lm_cache_init layout, batch of 1
    table_row: torch.Tensor,  # (M,) block table of the admitted slot
    block_size: int,
    start: int = 0,
) -> Cache:
    """Scatter one prefilled sequence's dense KV rows into the pools, in
    place, from logical position ``start`` on (rows past the slot's
    allocated blocks land in the trash block; pad rows inside them stay
    masked until decode overwrites them).  A non-zero ``start`` leaves the
    adopted prefix blocks untouched."""
    _require_no_windows(cfg)
    for pool, dense in zip(cache, prefill_cache):
        for name in ("k", "v"):
            paged_write_rows(pool[name], dense[name][0], table_row, block_size,
                             start=start)
    return cache


@torch.no_grad()
def lm_prefill_suffix(
    model: LM,
    cfg: ModelConfig,
    tokens: torch.Tensor,     # (1, S) suffix tokens, padded to a block multiple
    start: int,               # adopted prefix length, a multiple of block_size
    table_row: torch.Tensor,  # (M,) block table of the admitted slot
    cache: Cache,             # lm_paged_cache_init layout
    block_size: int,
    lengths: Optional[torch.Tensor] = None,  # (1,) true suffix length
) -> Tuple[torch.Tensor, Cache]:
    """Prefill only a prompt's suffix against adopted prefix blocks.

    The slot's first ``start`` positions already hold the prefix's K/V (a
    prefix-index hit); this pass embeds the suffix at positions
    ``start..start+S-1``, writes its K/V into the pools per layer, and runs
    ``flash_attention`` with ``q (1, Hq, S, D)`` against the gathered
    ``k, v (1, Hkv, start + S, D)``: the kernel's queries are the last S
    positions of the keys (``off = start``), so suffix queries see the
    adopted blocks as full prefill's rows ``start..`` see its prefix.
    With the plain attention on the CPU the logits equal full prefill's
    bit for bit, as in the reference; on the card the tensor-core kernel
    places the rows in other tiles, so they agree within its rounding.
    """
    _require_no_windows(cfg)
    s = tokens.shape[1]
    if start % block_size:
        raise ValueError(f"start {start} not a multiple of block_size {block_size}")
    if (start + s) % block_size:
        raise ValueError(
            f"suffix length {s} must pad start {start} to a block multiple")
    view_tbl = table_row[None, :(start + s) // block_size]
    x = embed_apply(model.embed, cfg, tokens)
    positions = start + torch.arange(s, device=x.device)[None, :]
    for layer, kv in zip(model.layers, cache):
        h = layer.ln1(x)
        q, k, v = _qkv(layer.attn, cfg, h)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        paged_write_rows(kv["k"], k[0].transpose(0, 1), table_row, block_size,
                         start=start)
        paged_write_rows(kv["v"], v[0].transpose(0, 1), table_row, block_size,
                         start=start)
        k_view = paged_view(kv["k"], view_tbl, block_size)  # (1, Hkv, start+S, Dh)
        v_view = paged_view(kv["v"], view_tbl, block_size)
        attn = flash_attention(q.transpose(1, 2), k_view, v_view, causal=True)
        x = x + attn.transpose(1, 2).reshape(1, s, -1) @ cast(layer.attn.wo, cfg)
        x = x + _ffn(layer, cfg, layer.ln2(x))[0]
    x = model.final_norm(x)
    return last_token_logits(model.embed, cfg, x, lengths), cache
