"""Uniform model API of the port, the counterpart of the reference's
``models/registry.py``.

``build_model(cfg)`` returns a :class:`ModelApi` whose entry points the
trainer and the serving engine program against:

  init(generator, device="cuda")  → model (an ``nn.Module``)
  loss(model, batch)              → (scalar, metrics)       [train step core]
  prefill(model, batch, max_len)  → (last_logits, cache)
  decode_step(model, token, pos, cache) → (logits, cache)
  cache_init(batch, max_len, device="cuda") → cache

``loss`` reads ``batch["tokens"]`` (B, S), ``batch["loss_mask"]`` (B, S)
when present and, on the VLM family, ``batch["patch_embeds"]`` (B, I, D),
as the reference's does; gradients flow through every kernel on its path.
``batch["lengths"]`` (B,) makes prefill read each sequence's true last
prompt position.  The dense, MoE, VLM, SSM (mamba2) and hybrid (Jamba)
families are ported; encoder-decoder (ROADMAP Queue 1 item 9) raises
``NotImplementedError``.

Transformer stacks without a sliding-window layer also expose the paged
cache of continuous batching (``None`` elsewhere: gemma3, the SSM and
hybrid families; ``supports_paged`` says which):

  paged_cache_init(n_blocks, block_size, device="cuda") → cache
  decode_step_paged(model, token, pos, tables, cache, block_size)
                                                   → (logits, cache)
  paged_prefill_write(cache, prefill_cache, table_row, block_size, start=0)
                                                   → cache
  prefill_suffix(model, tokens, start, table_row, cache, block_size,
                 lengths=None)                     → (logits, cache)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..configs.base import ModelConfig
from . import hybrid, ssm, transformer

__all__ = ["ModelApi", "build_model"]


@dataclasses.dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    cache_init: Callable
    # paged-KV serving contract (continuous batching); None where unsupported
    paged_cache_init: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    paged_prefill_write: Optional[Callable] = None
    prefill_suffix: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    def loss(model, batch):
        return transformer.lm_loss(
            model, cfg, batch["tokens"],
            loss_mask=batch.get("loss_mask"),
            extra_embeds=batch.get("patch_embeds"),
        )

    def prefill(model, batch, max_len=None):
        return transformer.lm_prefill(
            model, cfg, batch["tokens"],
            extra_embeds=batch.get("patch_embeds"),
            max_len=max_len,
            lengths=batch.get("lengths"),
        )

    # the block pool holds global-attention layers only (no sliding-window
    # ring buffers): gated here so engines can ask instead of raising
    paged = not any(w is not None for w in transformer.layer_windows(cfg))
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device="cuda": transformer.init_lm(cfg, generator, device),
        loss=loss,
        prefill=prefill,
        decode_step=lambda m, t, pos, c: transformer.lm_decode_step(m, cfg, t, pos, c),
        cache_init=lambda b, m, device="cuda": transformer.lm_cache_init(cfg, b, m, device),
        paged_cache_init=(
            (lambda n, bs, device="cuda":
             transformer.lm_paged_cache_init(cfg, n, bs, device))
            if paged else None
        ),
        decode_step_paged=(
            (lambda m, t, pos, tb, c, bs:
             transformer.lm_decode_step_paged(m, cfg, t, pos, tb, c, bs))
            if paged else None
        ),
        paged_prefill_write=(
            (lambda c, pc, row, bs, start=0:
             transformer.lm_paged_prefill_write(cfg, c, pc, row, bs, start=start))
            if paged else None
        ),
        prefill_suffix=(
            (lambda m, t, start, row, c, bs, lengths=None:
             transformer.lm_prefill_suffix(m, cfg, t, start, row, c, bs,
                                           lengths=lengths))
            if paged else None
        ),
    )


# the SSM and hybrid families: (init, loss, prefill, decode_step, cache_init)
_RECURRENT = {
    "ssm": (ssm.init_ssm, ssm.ssm_loss, ssm.ssm_prefill, ssm.ssm_decode_step,
            ssm.ssm_cache_init),
    "hybrid": (hybrid.init_hybrid, hybrid.hybrid_loss, hybrid.hybrid_prefill,
               hybrid.hybrid_decode_step, hybrid.hybrid_cache_init),
}


def _recurrent_api(cfg: ModelConfig) -> ModelApi:
    init, loss, prefill, decode_step, cache_init = _RECURRENT[cfg.family]
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device="cuda": init(cfg, generator, device),
        loss=lambda m, batch: loss(m, cfg, batch["tokens"],
                                   loss_mask=batch.get("loss_mask")),
        prefill=lambda m, batch, max_len=None: prefill(
            m, cfg, batch["tokens"], max_len=max_len, lengths=batch.get("lengths")),
        decode_step=lambda m, t, pos, c: decode_step(m, cfg, t, pos, c),
        cache_init=lambda b, m, device="cuda": cache_init(cfg, b, m, device),
    )


_LATER = {
    "encdec": "item 9 (models/encdec.py)",
}


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "moe", "vlm"):
        return _transformer_api(cfg)
    if cfg.family in _RECURRENT:
        return _recurrent_api(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP Queue 1 {_LATER[cfg.family]})"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
