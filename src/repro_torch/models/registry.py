"""Uniform model API of the port, the counterpart of the reference's
``models/registry.py``.

``build_model(cfg)`` returns a :class:`ModelApi` whose entry points the
serving engine programs against:

  init(generator, device="cuda")  → model (an ``nn.Module``)
  prefill(model, batch, max_len)  → (last_logits, cache)
  decode_step(model, token, pos, cache) → (logits, cache)
  cache_init(batch, max_len, device="cuda") → cache

``batch["lengths"]`` (B,) makes prefill read each sequence's true last
prompt position.  The dense, VLM, SSM (mamba2) and hybrid (Jamba)
families are ported.  ``loss`` (training, ROADMAP Queue 1 item 7) and the
paged-cache entry points of continuous batching (item 6b) are ``None``
until their slices; the transformer's MoE family (item 5b: wiring
``moe_apply`` into its decoder layers) and encoder-decoder (item 9) raise
``NotImplementedError``.
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
    prefill: Callable
    decode_step: Callable
    cache_init: Callable
    loss: Optional[Callable] = None
    # paged-KV serving contract (continuous batching); None until ported
    paged_cache_init: Optional[Callable] = None
    decode_step_paged: Optional[Callable] = None
    paged_prefill_write: Optional[Callable] = None
    prefill_suffix: Optional[Callable] = None

    @property
    def supports_paged(self) -> bool:
        return self.decode_step_paged is not None


def _transformer_api(cfg: ModelConfig) -> ModelApi:
    def prefill(model, batch, max_len=None):
        return transformer.lm_prefill(
            model, cfg, batch["tokens"],
            extra_embeds=batch.get("patch_embeds"),
            max_len=max_len,
            lengths=batch.get("lengths"),
        )

    return ModelApi(
        cfg=cfg,
        init=lambda generator, device="cuda": transformer.init_lm(cfg, generator, device),
        prefill=prefill,
        decode_step=lambda m, t, pos, c: transformer.lm_decode_step(m, cfg, t, pos, c),
        cache_init=lambda b, m, device="cuda": transformer.lm_cache_init(cfg, b, m, device),
    )


# the SSM and hybrid families: (init, prefill, decode_step, cache_init)
_RECURRENT = {
    "ssm": (ssm.init_ssm, ssm.ssm_prefill, ssm.ssm_decode_step, ssm.ssm_cache_init),
    "hybrid": (hybrid.init_hybrid, hybrid.hybrid_prefill,
               hybrid.hybrid_decode_step, hybrid.hybrid_cache_init),
}


def _recurrent_api(cfg: ModelConfig) -> ModelApi:
    init, prefill, decode_step, cache_init = _RECURRENT[cfg.family]
    return ModelApi(
        cfg=cfg,
        init=lambda generator, device="cuda": init(cfg, generator, device),
        prefill=lambda m, batch, max_len=None: prefill(
            m, cfg, batch["tokens"], max_len=max_len, lengths=batch.get("lengths")),
        decode_step=lambda m, t, pos, c: decode_step(m, cfg, t, pos, c),
        cache_init=lambda b, m, device="cuda": cache_init(cfg, b, m, device),
    )


_LATER = {
    "moe": ("item 5b (wiring models/moe.py's moe_apply into the transformer's "
            "DecoderLayer)"),
    "encdec": "item 9 (models/encdec.py)",
}


def build_model(cfg: ModelConfig) -> ModelApi:
    if cfg.family in ("dense", "vlm"):
        return _transformer_api(cfg)
    if cfg.family in _RECURRENT:
        return _recurrent_api(cfg)
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            f"(ROADMAP Queue 1 {_LATER[cfg.family]})"
        )
    raise ValueError(f"unknown family {cfg.family!r}")
