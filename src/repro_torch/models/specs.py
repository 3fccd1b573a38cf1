"""Logical axes of the port's parameters and caches.

The reference's ``init`` and ``cache_init`` return a spec beside every
array: a tuple with one logical axis name (or None) per dim, which
:mod:`repro_torch.dist.logical` resolves to mesh axes.  The port's
``nn.Module``s carry none, so :func:`param_specs` gives each parameter of
a port model its axes, keyed by the module's parameter names, and
:func:`cache_specs` does the same for a cache, in the cache's own
structure.  Each is the reference's table for the same tensor without its
stack axes: the reference stacks every layer's tensor over a leading
``"layers"`` axis (and ``"block_pos"`` inside a scanned block), the port
holds one tensor per layer.  :func:`reference_specs` puts the stack axes
back, under the reference's names (``models/weights.py``'s map), so the
two packages' tables can be compared entry for entry.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from .common import Attention, Embed, RMSNorm, SwiGLU
from .encdec import EncDec
from .mamba2 import Mamba2
from .moe import MoE
from .weights import reference_layout

__all__ = ["cache_specs", "param_specs", "reference_specs"]

LogicalSpec = Tuple[Any, ...]

# (module class, parameter name) → logical axes: the reference's
# ``attention_init``, ``mlp_init``, ``embed_init``, ``rmsnorm_init``,
# ``moe_init``, ``mamba_init`` and ``init_encdec`` tables.
_TABLE: Dict[Tuple[type, str], LogicalSpec] = {
    (Embed, "table"): ("vocab", "embed"),
    (Embed, "unembed"): ("embed", "vocab"),
    (RMSNorm, "weight"): ("embed_act",),
    (Attention, "wq"): ("embed", "heads"),
    (Attention, "wk"): ("embed", "heads"),
    (Attention, "wv"): ("embed", "heads"),
    (Attention, "wo"): ("heads", "embed"),
    (Attention, "bq"): ("heads",),
    (Attention, "bk"): ("heads",),
    (Attention, "bv"): ("heads",),
    (SwiGLU, "wg"): ("embed", "d_ff"),
    (SwiGLU, "wu"): ("embed", "d_ff"),
    (SwiGLU, "wd"): ("d_ff", "embed"),
    (MoE, "router"): (None, None),  # replicated: read by every shard every layer
    (MoE, "wg"): ("experts", "embed", "expert_ff"),
    (MoE, "wu"): ("experts", "embed", "expert_ff"),
    (MoE, "wd"): ("experts", "expert_ff", "embed"),
    (Mamba2, "in_proj"): ("embed", "conv_dim"),
    (Mamba2, "conv_w"): ("conv_dim", None),
    (Mamba2, "conv_b"): ("conv_dim",),
    (Mamba2, "a_log"): ("ssm_heads",),
    (Mamba2, "d_skip"): ("ssm_heads",),
    (Mamba2, "dt_bias"): ("ssm_heads",),
    (Mamba2, "norm_w"): ("conv_dim",),
    (Mamba2, "out_proj"): ("conv_dim", "embed"),
    (EncDec, "enc_pos"): ("frames", "embed"),
}


def param_specs(model: nn.Module) -> Dict[str, LogicalSpec]:
    """``{parameter name: logical axes}`` for every parameter of a port
    model (any of the registry's families)."""
    out = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        spec = _TABLE.get((type(mod), leaf))
        if spec is None:
            raise KeyError(f"no logical axes for parameter {name!r} "
                           f"({type(mod).__name__}.{leaf})")
        if len(spec) != p.dim():
            raise ValueError(f"{name}: spec {spec} for a {p.dim()}-d tensor")
        out[name] = spec
    return out


def _cache_leaf(key: str, t: torch.Tensor) -> LogicalSpec:
    """The reference's cache specs, per tensor, without the stack axes."""
    if key in ("k", "v"):
        # (B, Hkv, slots, Dh), the paged pool (Hkv, P, Dh), or the
        # encoder-decoder family's stacked (L, B, Hkv, rows, Dh)
        return {3: ("kv_heads", None, None),
                4: ("batch", "kv_heads", None, None),
                5: ("layers", "batch", "kv_heads", None, None)}[t.dim()]
    if key == "ssm":                       # (B, H, P, N)
        return ("batch", "ssm_heads", None, None)
    if key == "conv":                      # (B, K-1, conv_dim)
        return ("batch", None, "conv_dim")
    raise KeyError(f"no logical axes for cache tensor {key!r}")


def cache_specs(cache: Any) -> Any:
    """The logical axes of every tensor of a port cache, in the cache's
    structure: a list of per-layer dicts (the transformer, SSM and hybrid
    families, and the paged pools) or the encoder-decoder family's nested
    dict of stacked tensors."""
    if isinstance(cache, (list, tuple)):
        return [cache_specs(c) for c in cache]
    return {k: cache_specs(v) if isinstance(v, dict) else _cache_leaf(k, v)
            for k, v in cache.items()}


def reference_specs(model: nn.Module) -> Dict[str, LogicalSpec]:
    """:func:`param_specs` under the reference's parameter names, each with
    the reference's stack axes in front: ``"layers"`` for a stack of one
    dim, ``("layers", "block_pos")`` for two."""
    mine = param_specs(model)
    out = {}
    for ref, (lead, names) in reference_layout(model).items():
        specs = {mine[n] for n in names}
        if len(specs) != 1:
            raise ValueError(f"{ref}: the stacked parameters disagree: {specs}")
        stack = ("layers", "block_pos")[: len(lead)] if lead else ()
        out[ref] = stack + specs.pop()
    return out
