"""The parameter bridge: the reference's parameters ↔ the port's modules.

The reference keeps an LM's parameters as a nested dict whose flattened
names are ``embed/table``, ``embed/unembed``, ``final_norm`` and, stacked
over the scanned layer axis, ``blocks/ln1``, ``blocks/ln2``,
``blocks/attn/{wq,wk,wv,wo,bq,bk,bv}`` and ``blocks/mlp/{wg,wu,wd}`` (on
the MoE family ``blocks/moe/{router,wg,wu,wd}`` in its place): one
leading axis ``(n_layers, ...)``, or two for gemma3's local/global blocks
``(n_steps, local_block, ...)``, layer ``step * local_block + i``.  Those
are the names of a checkpoint the reference writes
(:mod:`repro_torch.checkpoint.manager` reads it).

:func:`params_from_reference` un-stacks them into an :class:`~.transformer.LM`
on ``device``, each matrix cast once to the compute dtype (the values the
reference's ``.astype(cdt)`` gives at each use), norm weights and the
router kept float32.
:func:`params_to_reference` is the inverse, float32 numpy arrays in the
reference's stacked layout.

The SSM family (:class:`~.ssm.SSM`) is named ``embed/*``, ``final_norm``,
``blocks/ln`` and ``blocks/mamba/{in_proj, conv_w, conv_b, a_log, d_skip,
dt_bias, norm_w, out_proj}``, stacked ``(n_layers, ...)``.  The hybrid
family (:class:`~.hybrid.Hybrid`) stacks twice, following ``_layout``:
``blocks/mamba/*`` ``(n_blocks, n_mamba, ...)``, ``blocks/attn/*``
``(n_blocks, ...)``, ``blocks/moe/{router, wg, wu, wd}`` and
``blocks/mlp/*`` ``(n_blocks, n_pos, ...)``, ``blocks/ln_mix`` and
``blocks/ln_ffn`` ``(n_blocks, per, d)``.  Cast to the compute dtype are
exactly the matrices the reference casts at use: ``in_proj``,
``out_proj``, the attention and MLP matrices and the experts' ``wg``,
``wu``, ``wd``; ``conv_w``, ``conv_b``, ``a_log``, ``d_skip``,
``dt_bias``, ``norm_w``, the router and every norm stay float32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .common import Attention, Embed, RMSNorm, SwiGLU, compute_dtype
from .hybrid import Hybrid, HybridLayer, _layout
from .mamba2 import _NAMES as _MAMBA, Mamba2
from .moe import MoE
from .ssm import SSM, SSMLayer
from .transformer import LM, DecoderLayer, _is_moe_layer, _n_scan

__all__ = ["params_from_reference", "params_to_reference"]

Array = Union[np.ndarray, torch.Tensor]
_ATTN = ("wq", "wk", "wv", "wo")
_BIAS = ("bq", "bk", "bv")
_MLP = ("wg", "wu", "wd")
_MAMBA_CAST = ("in_proj", "out_proj")
_MOE = ("router", "wg", "wu", "wd")
_MOE_CAST = ("wg", "wu", "wd")


def _tensor(a: Array) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array from the reference
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_reference(cfg: ModelConfig, named: Mapping[str, Array],
                          device: DeviceLike = "cuda"):
    """The port's model (LM, SSM or Hybrid, by ``cfg.family``) holding the
    reference's parameters ``named``."""
    dev = resolve_device(device)
    missing = [n for n in _names(cfg) if n not in named]
    if missing:
        raise KeyError(f"reference parameters missing: {missing[:5]}")
    if cfg.family == "ssm":
        return _ssm_from_reference(cfg, named, dev)
    if cfg.family == "hybrid":
        return _hybrid_from_reference(cfg, named, dev)
    return _lm_from_reference(cfg, named, dev)


def _embed(cfg: ModelConfig, named, dev) -> Tuple[Embed, RMSNorm]:
    cdt = compute_dtype(cfg)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = _tensor(named["embed/unembed"]).to(device=dev, dtype=cdt)
    embed = Embed(_tensor(named["embed/table"]).to(device=dev, dtype=cdt), unembed)
    return embed, RMSNorm(_tensor(named["final_norm"]).to(dev), cfg.norm_eps)


def _stacked(named, name: str, lead: Tuple[int, ...]) -> torch.Tensor:
    t = _tensor(named[name])
    if tuple(t.shape[:len(lead)]) != lead:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, stack {lead}")
    return t


def _mamba(cfg: ModelConfig, blk: Dict[str, torch.Tensor], idx, dev) -> Mamba2:
    cdt = compute_dtype(cfg)
    return Mamba2(*(blk[n][idx].to(device=dev,
                                   dtype=cdt if n in _MAMBA_CAST else torch.float32)
                    for n in _MAMBA))


def _ssm_from_reference(cfg: ModelConfig, named, dev) -> SSM:
    lead = (cfg.n_layers,)
    blk = {n: _stacked(named, f"blocks/mamba/{n}", lead) for n in _MAMBA}
    ln = _stacked(named, "blocks/ln", lead)
    layers = [SSMLayer(RMSNorm(ln[i].to(dev), cfg.norm_eps), _mamba(cfg, blk, i, dev))
              for i in range(cfg.n_layers)]
    embed, final = _embed(cfg, named, dev)
    return SSM(cfg, embed, layers, final)


def _hybrid_from_reference(cfg: ModelConfig, named, dev) -> Hybrid:
    cdt = compute_dtype(cfg)
    n_blocks, per, mamba_pos, moe_pos, mlp_pos = _layout(cfg)
    attn_names = _ATTN + (_BIAS if cfg.qkv_bias else ())

    def group(prefix, names, n_pos):
        lead = (n_blocks, n_pos) if n_pos else (n_blocks,)
        return {n: _stacked(named, f"blocks/{prefix}/{n}", lead) for n in names}

    mamba = group("mamba", _MAMBA, len(mamba_pos))
    attn = group("attn", attn_names, 0)
    moe = group("moe", _MOE, len(moe_pos)) if moe_pos else {}
    mlp = group("mlp", _MLP, len(mlp_pos)) if mlp_pos else {}
    ln_mix = _stacked(named, "blocks/ln_mix", (n_blocks, per))
    ln_ffn = _stacked(named, "blocks/ln_ffn", (n_blocks, per))
    layers = []
    for blk in range(n_blocks):
        for j in range(per):
            if j == cfg.attn_index:
                bias = [attn[n][blk].to(dev, cdt) if cfg.qkv_bias else None
                        for n in _BIAS]
                mixer = Attention(*(attn[n][blk].to(dev, cdt) for n in _ATTN), *bias)
            else:
                mixer = _mamba(cfg, mamba, (blk, mamba_pos.index(j)), dev)
            if j in moe_pos:
                f = moe_pos.index(j)
                ffn = MoE(*(moe[n][blk, f].to(dev, cdt if n in _MOE_CAST
                                               else torch.float32)
                            for n in _MOE))
            else:
                f = mlp_pos.index(j)
                ffn = SwiGLU(*(mlp[n][blk, f].to(dev, cdt) for n in _MLP))
            layers.append(HybridLayer(RMSNorm(ln_mix[blk, j].to(dev), cfg.norm_eps),
                                      mixer,
                                      RMSNorm(ln_ffn[blk, j].to(dev), cfg.norm_eps),
                                      ffn))
    embed, final = _embed(cfg, named, dev)
    return Hybrid(cfg, embed, layers, final)


def _lm_from_reference(cfg: ModelConfig, named, dev) -> LM:
    cdt = compute_dtype(cfg)
    n_steps, per = _n_scan(cfg)

    def mat(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=cdt)

    lead = (n_steps,) if per == 1 else (n_steps, per)

    def stacked(name: str) -> torch.Tensor:
        t = _stacked(named, name, lead)
        return t.reshape(cfg.n_layers, *t.shape[len(lead):])

    moe = _is_moe_layer(cfg)
    blk = {n: stacked(f"blocks/attn/{n}") for n in _ATTN}
    if cfg.qkv_bias:
        blk.update({n: stacked(f"blocks/attn/{n}") for n in _BIAS})
    ffn_names = _MOE if moe else _MLP
    ffn_blk = {n: stacked(f"blocks/{'moe' if moe else 'mlp'}/{n}") for n in ffn_names}
    ln1, ln2 = stacked("blocks/ln1"), stacked("blocks/ln2")
    layers = []
    for i in range(cfg.n_layers):
        bias = [mat(blk[n][i]) if cfg.qkv_bias else None for n in _BIAS]
        attn = Attention(*(mat(blk[n][i]) for n in _ATTN), *bias)
        if moe:
            ffn = dict(moe=MoE(*(ffn_blk[n][i].to(dev, cdt if n in _MOE_CAST
                                                  else torch.float32)
                                 for n in _MOE)))
        else:
            ffn = dict(mlp=SwiGLU(*(mat(ffn_blk[n][i]) for n in _MLP)))
        layers.append(DecoderLayer(RMSNorm(ln1[i].to(dev), cfg.norm_eps), attn,
                                   RMSNorm(ln2[i].to(dev), cfg.norm_eps), **ffn))
    embed, final = _embed(cfg, named, dev)
    return LM(cfg, embed, layers, final)


def _names(cfg: ModelConfig):
    names = ["embed/table", "final_norm"]
    if not cfg.tie_embeddings:
        names.append("embed/unembed")
    if cfg.family == "ssm":
        return names + ["blocks/ln"] + [f"blocks/mamba/{n}" for n in _MAMBA]
    attn = [f"blocks/attn/{n}" for n in _ATTN + (_BIAS if cfg.qkv_bias else ())]
    if cfg.family == "hybrid":
        _, _, _, moe_pos, mlp_pos = _layout(cfg)
        names += ["blocks/ln_mix", "blocks/ln_ffn"] + attn
        names += [f"blocks/mamba/{n}" for n in _MAMBA]
        names += [f"blocks/moe/{n}" for n in _MOE] if moe_pos else []
        names += [f"blocks/mlp/{n}" for n in _MLP] if mlp_pos else []
        return names
    ffn = ([f"blocks/moe/{n}" for n in _MOE] if _is_moe_layer(cfg)
           else [f"blocks/mlp/{n}" for n in _MLP])
    return names + ["blocks/ln1", "blocks/ln2"] + attn + ffn


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def params_to_reference(model) -> Dict[str, np.ndarray]:
    """The inverse: ``{name: float32 array}`` in the reference's layout."""
    cfg = model.cfg
    out = {"embed/table": _host(model.embed.table),
           "final_norm": _host(model.final_norm.weight)}
    if not cfg.tie_embeddings:
        out["embed/unembed"] = _host(model.embed.unembed)
    if isinstance(model, SSM):
        out["blocks/ln"] = np.stack([_host(l.ln.weight) for l in model.layers])
        for n in _MAMBA:
            out[f"blocks/mamba/{n}"] = np.stack(
                [_host(getattr(l.mamba, n)) for l in model.layers])
        return out
    if isinstance(model, Hybrid):
        return {**out, **_hybrid_to_reference(model)}

    n_steps, per = _n_scan(cfg)
    lead = (n_steps,) if per == 1 else (n_steps, per)

    def stack(get) -> np.ndarray:
        a = np.stack([_host(get(layer)) for layer in model.layers])
        return a.reshape(*lead, *a.shape[1:])

    out["blocks/ln1"] = stack(lambda l: l.ln1.weight)
    out["blocks/ln2"] = stack(lambda l: l.ln2.weight)
    for n in _ATTN + (_BIAS if cfg.qkv_bias else ()):
        out[f"blocks/attn/{n}"] = stack(lambda l, n=n: getattr(l.attn, n))
    if _is_moe_layer(cfg):
        for n in _MOE:
            out[f"blocks/moe/{n}"] = stack(lambda l, n=n: getattr(l.moe, n))
    else:
        for n in _MLP:
            out[f"blocks/mlp/{n}"] = stack(lambda l, n=n: getattr(l.mlp, n))
    return out


def _hybrid_to_reference(model: Hybrid) -> Dict[str, np.ndarray]:
    cfg = model.cfg
    n_blocks, per, mamba_pos, moe_pos, mlp_pos = _layout(cfg)
    blocks = [model.layers[b * per:(b + 1) * per] for b in range(n_blocks)]

    def stack(positions, module, names, prefix) -> Dict[str, np.ndarray]:
        return {f"blocks/{prefix}/{n}": np.stack([
            np.stack([_host(getattr(getattr(blk[j], module), n)) for j in positions])
            for blk in blocks]) for n in names}

    out = {
        "blocks/ln_mix": np.stack([[_host(l.ln_mix.weight) for l in blk] for blk in blocks]),
        "blocks/ln_ffn": np.stack([[_host(l.ln_ffn.weight) for l in blk] for blk in blocks]),
    }
    for n in _ATTN + (_BIAS if cfg.qkv_bias else ()):
        out[f"blocks/attn/{n}"] = np.stack(
            [_host(getattr(blk[cfg.attn_index].mixer, n)) for blk in blocks])
    out.update(stack(mamba_pos, "mixer", _MAMBA, "mamba"))
    if moe_pos:
        out.update(stack(moe_pos, "ffn", _MOE, "moe"))
    if mlp_pos:
        out.update(stack(mlp_pos, "ffn", _MLP, "mlp"))
    return out
