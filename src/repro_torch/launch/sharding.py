"""Sharding assembly of the port: logical specs → DTensor placements (the
reference's ``launch/sharding.py``, whose NamedShardings become one tuple
of placements per tensor, one placement per mesh dim).

:func:`distribute_params` and :func:`distribute_tree` then lay a module's
parameters, or a cache, out by those placements.  Where every mesh dim
that shards a tensor has extent 1 (a 1×1 mesh, or "model" = 1 on a tensor
sharded only over "model"), the local tensor *is* the whole tensor, and it
is wrapped with ``DTensor.from_local`` without a copy; elsewhere every
rank holds the whole tensor (the same seed, the same checkpoint) and
``distribute_tensor`` keeps its own shard of it, with no communication.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from ..dist.logical import (
    current_rules,
    divisible_spec,
    mesh_axis_names,
    mesh_sizes,
    placements,
)
from .mesh import dp_axes

__all__ = [
    "batch_shardings",
    "distribute",
    "distribute_params",
    "distribute_tree",
    "module_copy",
    "redistribute_tree",
    "replicated",
    "resolve_spec",
    "shardings_from_specs",
    "state_shardings",
]


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(s is None or isinstance(s, str) for s in x)


def _tree_map(fn, specs, shapes=None):
    """Map ``fn(spec, shape)`` over a tree of dicts and lists whose leaves
    are logical specs, with a matching tree of tensors (or shapes)."""
    if _is_spec(specs):
        return fn(specs, shapes)
    if isinstance(specs, Mapping):
        return {k: _tree_map(fn, v, None if shapes is None else shapes[k])
                for k, v in specs.items()}
    return [_tree_map(fn, v, None if shapes is None else shapes[i])
            for i, v in enumerate(specs)]


def shardings_from_specs(mesh, specs, shapes=None):
    """Map a tree of logical-axis tuples to DTensor placements.

    With ``shapes`` (a matching tree of tensors or shapes), mesh axes that
    don't divide the corresponding dim are dropped — and a ``kv_heads``
    split that fails (GQA kv < model size) falls back to sharding the
    cache's sequence dim over "model" instead (sequence-parallel KV: the
    attention kernels then take whole sequences, see
    ``models/common.py``)."""
    return _tree_map(lambda spec, shape=None: placements(
        resolve_spec(mesh, spec, shape), mesh), specs, shapes)


def resolve_spec(mesh, spec, shape=None) -> tuple:
    """One logical spec → its mesh-axis spec on ``mesh`` under the active
    rules: with ``shape``, non-dividing axes dropped and the KV-cache
    fallback applied (:func:`shardings_from_specs`)."""
    p = current_rules().spec(spec, mesh)
    if shape is None:
        return p
    dims = tuple(shape.shape if hasattr(shape, "shape") else shape)
    q = divisible_spec(p, dims, mesh)
    if ("kv_heads" in spec and "model" in mesh_axis_names(mesh)
            and all(pp != "model" for pp in q)):
        n_model = mesh_sizes(mesh)["model"]
        ki = spec.index("kv_heads")
        parts = list(q) + [None] * (len(dims) - len(q))
        for j in range(ki + 1, len(dims)):
            if parts[j] is None and dims[j] % n_model == 0 and dims[j] > 1:
                parts[j] = "model"
                break
        q = tuple(parts)
    return q


def replicated(mesh) -> tuple:
    """Placements of a tensor held whole on every rank."""
    return placements((), mesh)


def batch_shardings(mesh, batch: Mapping[str, Any]) -> Dict[str, tuple]:
    """Inputs: leading batch dim over the dp axes, the rest replicated.

    A batch dim that doesn't divide the dp extent (batch = 1 long-context
    decode) is left replicated."""
    dp = dp_axes(mesh)
    sizes = mesh_sizes(mesh)
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    dp_entry = dp if len(dp) > 1 else (dp[0] if dp else None)

    def one(t):
        shape = tuple(t.shape if hasattr(t, "shape") else t)
        if not shape or shape[0] % n_dp:
            return replicated(mesh)
        return placements((dp_entry,), mesh)

    return {k: one(v) for k, v in batch.items()}


def state_shardings(mesh, param_specs, shapes=None) -> Dict[str, Any]:
    """Train-state placements: the parameters, AdamW's ``m`` and ``v``
    mirroring them, a replicated ``count`` and ``step``."""
    ps = shardings_from_specs(mesh, param_specs, shapes)
    repl = replicated(mesh)
    return {"params": ps, "opt": {"m": ps, "v": ps, "count": repl}, "step": repl}


def _local_is_whole(mesh, pl: Sequence) -> bool:
    return all(p.is_replicate() or mesh.size(i) == 1 for i, p in enumerate(pl))


def distribute(t: torch.Tensor, mesh, pl: Sequence):
    """``t`` (the whole tensor, on every rank) as a DTensor laid out by
    ``pl``: wrapped without a copy when the local shard is the whole
    tensor, else each rank's shard cut from its own copy."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        raise TypeError("already a DTensor")
    if _local_is_whole(mesh, pl) and not t.is_meta:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    # every rank holds the whole tensor: each keeps its own shard, no scatter
    return distribute_tensor(t, mesh, list(pl), src_data_rank=None)


def module_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model``'s module tree whose parameter slots are its own
    and whose tensors are ``model``'s (no data is copied), so that
    :func:`distribute_params` on the copy leaves ``model`` as it was."""
    new = copy.copy(model)
    new._parameters = dict(model._parameters)
    new._buffers = dict(model._buffers)
    new._modules = {k: None if m is None else module_copy(m)
                    for k, m in model._modules.items()}
    return new


def distribute_params(model: nn.Module, mesh, param_specs: Optional[Mapping] = None):
    """Lay ``model``'s parameters out over ``mesh`` in place, by their
    logical specs (``models.specs.param_specs``), replicated where
    ``param_specs`` is None; ``requires_grad`` is kept.  Returns
    ``model``."""
    named = dict(model.named_parameters())
    if param_specs is None:
        pls = {n: replicated(mesh) for n in named}
    else:
        pls = shardings_from_specs(mesh, dict(param_specs),
                                   {n: p.shape for n, p in named.items()})
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        mod._parameters[leaf] = nn.Parameter(
            distribute(p.detach(), mesh, pls[name]), requires_grad=p.requires_grad)
    return model


def redistribute_tree(tree, pls):
    """A tree of DTensors, each redistributed to its placements in a
    matching tree of them."""
    if isinstance(tree, torch.Tensor):
        if tuple(tree.placements) == tuple(pls):
            return tree
        return tree.redistribute(tree.device_mesh, pls)
    if isinstance(tree, Mapping):
        return {k: redistribute_tree(v, pls[k]) for k, v in tree.items()}
    return [redistribute_tree(v, pls[i]) for i, v in enumerate(tree)]


def distribute_tree(tree, mesh, pls):
    """A tree of tensors (dicts and lists) laid out by a matching tree of
    placements (:func:`shardings_from_specs` with ``shapes``)."""
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, pls)
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, mesh, pls[k]) for k, v in tree.items()}
    return [distribute_tree(v, mesh, pls[i]) for i, v in enumerate(tree)]
