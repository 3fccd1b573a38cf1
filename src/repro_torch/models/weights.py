"""The parameter bridge: the reference's parameters ↔ the port's modules.

The reference keeps an LM's parameters as a nested dict whose flattened
names are ``embed/table``, ``embed/unembed``, ``final_norm`` and, stacked
over the scanned layer axis, ``blocks/ln1``, ``blocks/ln2``,
``blocks/attn/{wq,wk,wv,wo,bq,bk,bv}`` and ``blocks/mlp/{wg,wu,wd}``: one
leading axis ``(n_layers, ...)``, or two for gemma3's local/global blocks
``(n_steps, local_block, ...)``, layer ``step * local_block + i``.  Those
are the names of a checkpoint the reference writes
(:mod:`repro_torch.checkpoint.manager` reads it).

:func:`params_from_reference` un-stacks them into an :class:`~.transformer.LM`
on ``device``, each matrix cast once to the compute dtype (the values the
reference's ``.astype(cdt)`` gives at each use), norm weights kept float32.
:func:`params_to_reference` is the inverse, float32 numpy arrays in the
reference's stacked layout.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .common import Attention, Embed, RMSNorm, SwiGLU, compute_dtype
from .transformer import LM, DecoderLayer, _n_scan, _require_dense

__all__ = ["params_from_reference", "params_to_reference"]

Array = Union[np.ndarray, torch.Tensor]
_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_MLP = ("wg", "wu", "wd")


def _tensor(a: Array) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array from the reference
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(cfg: ModelConfig, named: Mapping[str, Array],
                          device: DeviceLike = "cuda") -> LM:
    """The port's LM holding the reference's parameters ``named``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    cdt = compute_dtype(cfg)
    n_steps, per = _n_scan(cfg)
    missing = [n for n in _names(cfg) if n not in named]
    if missing:
        raise KeyError(f"reference parameters missing: {missing[:5]}")

    def mat(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=cdt)

    def stacked(name: str) -> torch.Tensor:
        t = _tensor(named[name])
        lead = (n_steps,) if per == 1 else (n_steps, per)
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, stack {lead}")
        return t.reshape(cfg.n_layers, *t.shape[len(lead):])

    blk = {n: stacked(f"blocks/attn/{n}") for n in _ATTN}
    if cfg.qkv_bias:
        blk.update({n: stacked(f"blocks/attn/{n}") for n in _BIAS})
    blk.update({n: stacked(f"blocks/mlp/{n}") for n in _MLP})
    ln1, ln2 = stacked("blocks/ln1"), stacked("blocks/ln2")
    layers = []
    for i in range(cfg.n_layers):
        bias = [mat(blk[n][i]) if cfg.qkv_bias else None for n in _BIAS]
        attn = Attention(*(mat(blk[n][i]) for n in _ATTN), *bias)
        mlp = SwiGLU(*(mat(blk[n][i]) for n in _MLP))
        layers.append(DecoderLayer(RMSNorm(ln1[i].to(dev), cfg.norm_eps), attn,
                                   RMSNorm(ln2[i].to(dev), cfg.norm_eps), mlp))
    unembed = None if cfg.tie_embeddings else mat(_tensor(named["embed/unembed"]))
    embed = Embed(mat(_tensor(named["embed/table"])), unembed)
    final = RMSNorm(_tensor(named["final_norm"]).to(dev), cfg.norm_eps)
    return LM(cfg, embed, layers, final)


def _names(cfg: ModelConfig):
    names = ["embed/table", "final_norm", "blocks/ln1", "blocks/ln2"]
    names += [f"blocks/attn/{n}" for n in _ATTN + (_BIAS if cfg.qkv_bias else ())]
    names += [f"blocks/mlp/{n}" for n in _MLP]
    if not cfg.tie_embeddings:
        names.append("embed/unembed")
    return names


def params_to_reference(model: LM) -> Dict[str, np.ndarray]:
    """The inverse: ``{name: float32 array}`` in the reference's layout."""
    cfg = model.cfg
    n_steps, per = _n_scan(cfg)
    lead = (n_steps,) if per == 1 else (n_steps, per)

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    def stack(get) -> np.ndarray:
        a = np.stack([host(get(layer)) for layer in model.layers])
        return a.reshape(*lead, *a.shape[1:])

    out = {"embed/table": host(model.embed.table),
           "final_norm": host(model.final_norm.weight),
           "blocks/ln1": stack(lambda l: l.ln1.weight),
           "blocks/ln2": stack(lambda l: l.ln2.weight)}
    for n in _ATTN + (_BIAS if cfg.qkv_bias else ()):
        out[f"blocks/attn/{n}"] = stack(lambda l, n=n: getattr(l.attn, n))
    for n in _MLP:
        out[f"blocks/mlp/{n}"] = stack(lambda l, n=n: getattr(l.mlp, n))
    if not cfg.tie_embeddings:
        out["embed/unembed"] = host(model.embed.unembed)
    return out
