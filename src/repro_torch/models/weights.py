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

The encoder-decoder family (:class:`~.encdec.EncDec`) adds ``enc_pos``
and ``enc_norm`` to ``embed/*`` and ``final_norm``, and stacks
``enc_blocks/{ln1, ln2}``, ``enc_blocks/attn/*``, ``enc_blocks/mlp/*``
``(n_enc_layers, ...)`` and ``dec_blocks/{ln1, ln2, ln3}``,
``dec_blocks/self/*``, ``dec_blocks/cross/*``, ``dec_blocks/mlp/*``
``(n_layers, ...)``; ``enc_pos`` is cast to the compute dtype with the
matrices.

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

:func:`reference_layout` maps each reference name to the module's
parameter names it stacks, which carries any per-parameter tensors across
(:func:`named_to_reference`, :func:`named_from_reference`), and with it
the whole **train state**: :func:`state_to_reference` writes a port train
state (float32 master parameters, AdamW ``m``/``v``/``count``, ``step``,
a compressor's error-feedback residual) under the names of the
reference's train state (``params/...``, ``opt/m/...``, ``opt/v/...``,
``opt/count``, ``step``, ``ef_residual/...``), and
:func:`load_state_reference` loads such names, from either package's
checkpoint, into a port train state.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from .common import Attention, Embed, RMSNorm, SwiGLU, compute_dtype
from .encdec import DecoderLayer as EncDecLayer, EncDec, EncoderLayer
from .hybrid import Hybrid, HybridLayer, _layout
from .mamba2 import _NAMES as _MAMBA, Mamba2
from .moe import MoE
from .ssm import SSM, SSMLayer
from .transformer import LM, DecoderLayer, _is_moe_layer, _n_scan

__all__ = [
    "load_state_reference",
    "named_from_reference",
    "named_to_reference",
    "params_from_reference",
    "params_to_reference",
    "reference_layout",
    "state_reference_names",
    "state_to_reference",
]

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
    """The port's model (LM, SSM, Hybrid or EncDec, by ``cfg.family``)
    holding the reference's parameters ``named``."""
    dev = resolve_device(device)
    missing = [n for n in _names(cfg) if n not in named]
    if missing:
        raise KeyError(f"reference parameters missing: {missing[:5]}")
    if cfg.family == "ssm":
        return _ssm_from_reference(cfg, named, dev)
    if cfg.family == "hybrid":
        return _hybrid_from_reference(cfg, named, dev)
    if cfg.family == "encdec":
        return _encdec_from_reference(cfg, named, dev)
    return _lm_from_reference(cfg, named, dev)


def _encdec_layout(cfg: ModelConfig) -> Dict[str, Tuple[Tuple[int, ...], List[str]]]:
    """:func:`reference_layout` of the encoder-decoder family beyond
    ``embed/*`` and ``final_norm``."""
    attn = _ATTN + (_BIAS if cfg.qkv_bias else ())
    out = {"enc_pos": ((), ["enc_pos"]), "enc_norm": ((), ["enc_norm.weight"])}
    for stack, n, norms, subs in (
            ("enc_blocks", cfg.n_enc_layers, ("ln1", "ln2"),
             (("attn", attn), ("mlp", _MLP))),
            ("dec_blocks", cfg.n_layers, ("ln1", "ln2", "ln3"),
             (("self", attn), ("cross", attn), ("mlp", _MLP)))):
        for ln in norms:
            out[f"{stack}/{ln}"] = ((n,), [f"{stack}.{i}.{ln}.weight" for i in range(n)])
        for sub, names in subs:
            for p in names:
                out[f"{stack}/{sub}/{p}"] = ((n,), [f"{stack}.{i}.{sub}.{p}"
                                                    for i in range(n)])
    return out


def _encdec_from_reference(cfg: ModelConfig, named, dev) -> EncDec:
    cdt = compute_dtype(cfg)
    flat = {}  # the module's parameter name -> its (unstacked) tensor
    for ref, (lead, names) in _encdec_layout(cfg).items():
        t = _stacked(named, ref, lead)
        flat.update(zip(names, t.reshape(-1, *t.shape[len(lead):]) if lead else [t]))

    def mat(name):
        return flat[name].to(dev, cdt)

    def norm(name):
        return RMSNorm(flat[f"{name}.weight"].to(dev), cfg.norm_eps)

    def attn(prefix):
        bias = [mat(f"{prefix}.{p}") if cfg.qkv_bias else None for p in _BIAS]
        return Attention(*(mat(f"{prefix}.{p}") for p in _ATTN), *bias)

    def mlp(prefix):
        return SwiGLU(*(mat(f"{prefix}.{p}") for p in _MLP))

    enc = [EncoderLayer(norm(f"{x}.ln1"), attn(f"{x}.attn"), norm(f"{x}.ln2"),
                        mlp(f"{x}.mlp"))
           for x in (f"enc_blocks.{i}" for i in range(cfg.n_enc_layers))]
    dec = [EncDecLayer(norm(f"{x}.ln1"), attn(f"{x}.self"), norm(f"{x}.ln2"),
                       attn(f"{x}.cross"), norm(f"{x}.ln3"), mlp(f"{x}.mlp"))
           for x in (f"dec_blocks.{i}" for i in range(cfg.n_layers))]
    embed, final = _embed(cfg, named, dev)
    return EncDec(cfg, embed, mat("enc_pos"), enc, norm("enc_norm"), dec, final)


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
    if cfg.family == "encdec":
        return names + list(_encdec_layout(cfg))
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


def reference_layout(model) -> Dict[str, Tuple[Tuple[int, ...], List[str]]]:
    """``{reference name: (stack shape, [the module's parameter name of each
    stacked entry, in C order])}`` of an LM, SSM, Hybrid or EncDec; the
    stack shape is ``()`` for an unstacked tensor (``embed/*``,
    ``final_norm``, ``enc_pos``, ``enc_norm``)."""
    cfg = model.cfg
    out: Dict[str, Tuple[Tuple[int, ...], List[str]]] = {
        "embed/table": ((), ["embed.table"]),
        "final_norm": ((), ["final_norm.weight"]),
    }
    if not cfg.tie_embeddings:
        out["embed/unembed"] = ((), ["embed.unembed"])
    attn = _ATTN + (_BIAS if cfg.qkv_bias else ())
    if isinstance(model, EncDec):
        return {**out, **_encdec_layout(cfg)}
    if isinstance(model, SSM):
        lead = (cfg.n_layers,)
        out["blocks/ln"] = (lead, [f"layers.{i}.ln.weight" for i in range(cfg.n_layers)])
        for n in _MAMBA:
            out[f"blocks/mamba/{n}"] = (lead, [f"layers.{i}.mamba.{n}"
                                               for i in range(cfg.n_layers)])
        return out
    if isinstance(model, Hybrid):
        n_blocks, per, mamba_pos, moe_pos, mlp_pos = _layout(cfg)

        def group(prefix, module, names, positions, lead):
            for n in names:
                out[f"blocks/{prefix}/{n}"] = (lead, [
                    f"layers.{b * per + j}.{module}.{n}"
                    for b in range(n_blocks) for j in positions])

        for ln in ("ln_mix", "ln_ffn"):
            out[f"blocks/{ln}"] = ((n_blocks, per), [
                f"layers.{i}.{ln}.weight" for i in range(cfg.n_layers)])
        group("attn", "mixer", attn, [cfg.attn_index], (n_blocks,))
        group("mamba", "mixer", _MAMBA, mamba_pos, (n_blocks, len(mamba_pos)))
        if moe_pos:
            group("moe", "ffn", _MOE, moe_pos, (n_blocks, len(moe_pos)))
        if mlp_pos:
            group("mlp", "ffn", _MLP, mlp_pos, (n_blocks, len(mlp_pos)))
        return out
    n_steps, per = _n_scan(cfg)
    lead = (n_steps,) if per == 1 else (n_steps, per)
    layers = range(cfg.n_layers)
    for ln in ("ln1", "ln2"):
        out[f"blocks/{ln}"] = (lead, [f"layers.{i}.{ln}.weight" for i in layers])
    for n in attn:
        out[f"blocks/attn/{n}"] = (lead, [f"layers.{i}.attn.{n}" for i in layers])
    ffn, names = ("moe", _MOE) if _is_moe_layer(cfg) else ("mlp", _MLP)
    for n in names:
        out[f"blocks/{ffn}/{n}"] = (lead, [f"layers.{i}.{ffn}.{n}" for i in layers])
    return out


def named_to_reference(model, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Tensors keyed by ``model``'s parameter names (the parameters, their
    gradients, moments or residuals) → host copies in the reference's
    stacked layout, in their own dtype."""
    out = {}
    for ref, (lead, names) in reference_layout(model).items():
        if not lead:
            out[ref] = named[names[0]].detach().to("cpu", copy=True)
            continue
        ts = [named[n].detach().cpu() for n in names]
        out[ref] = torch.stack(ts).reshape(*lead, *ts[0].shape)
    return out


def named_from_reference(model, ref: Mapping[str, Array]) -> Dict[str, torch.Tensor]:
    """The inverse: ``{parameter name: tensor}`` (views of the stacked
    tensors, where they lie) from reference-named, stacked tensors."""
    out = {}
    for name, (lead, names) in reference_layout(model).items():
        t = _stacked(ref, name, lead)
        flat = t.reshape(-1, *t.shape[len(lead):]) if lead else t[None]
        for i, n in enumerate(names):
            out[n] = flat[i]
    return out


def params_to_reference(model) -> Dict[str, np.ndarray]:
    """The inverse of :func:`params_from_reference`: ``{name: float32
    array}`` in the reference's layout."""
    return {n: t.float().numpy() for n, t in
            named_to_reference(model, dict(model.named_parameters())).items()}


# -- the train state ------------------------------------------------------------

_STATE_KEYS = ("model", "opt", "step")


def _per_param(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{reference prefix: per-parameter dict}`` of a train state: the
    moments and every extra per-parameter entry (a compressor's residual)."""
    out = {"opt/m": state["opt"]["m"], "opt/v": state["opt"]["v"]}
    out.update({k: v for k, v in state.items() if k not in _STATE_KEYS})
    return out


def state_to_reference(state) -> Dict[str, torch.Tensor]:
    """A port train state (``train.loop.make_train_state``) → host copies
    under the reference's train-state names: ``params/<name>``,
    ``opt/m/<name>``, ``opt/v/<name>``, ``opt/count``, ``step`` and, with a
    compressor, ``<state_key>/<name>``; the names a checkpoint of either
    package holds."""
    model = state["model"]
    out = {f"params/{n}": t for n, t in
           named_to_reference(model, dict(model.named_parameters())).items()}
    for prefix, named in _per_param(state).items():
        out.update({f"{prefix}/{n}": t for n, t in
                    named_to_reference(model, named).items()})
    out["opt/count"] = state["opt"]["count"].detach().to("cpu", copy=True)
    out["step"] = state["step"].detach().to("cpu", copy=True)
    return out


def state_reference_names(state) -> List[str]:
    """The names :func:`state_to_reference` writes, without copying."""
    refs = list(reference_layout(state["model"]))
    names = [f"params/{n}" for n in refs]
    for prefix in _per_param(state):
        names += [f"{prefix}/{n}" for n in refs]
    return names + ["opt/count", "step"]


@torch.no_grad()
def load_state_reference(state, named: Mapping[str, Array]):
    """Copy a reference-named train state (:func:`state_to_reference`'s
    names, from either package) into ``state``: parameters, moments and
    residuals in place, each in its own dtype and device; ``count`` and
    ``step`` replaced.  Returns ``state``."""
    model = state["model"]

    def load(prefix, targets):
        sub = {n[len(prefix) + 1:]: t for n, t in named.items()
               if n.startswith(prefix + "/")}
        for n, t in named_from_reference(model, sub).items():
            targets[n].copy_(t)

    load("params", dict(model.named_parameters()))
    for prefix, targets in _per_param(state).items():
        load(prefix, targets)
    dev = state["step"].device
    state["opt"]["count"] = _tensor(named["opt/count"]).to(dev, torch.int32)
    state["step"] = _tensor(named["step"]).to(dev, torch.int32)
    return state
