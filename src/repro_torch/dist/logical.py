"""Named logical-axis sharding of the port: rule table, spec derivation,
``constrain`` (the reference's ``dist/logical.py`` on DTensor).

The models never mention mesh axes.  They speak in *logical* axis names —
"batch", "seq", "heads", "embed", "d_ff", … — both for parameter specs
(:mod:`repro_torch.models.specs`) and for activation annotations
(:func:`constrain` calls at layer boundaries).  This module owns the
translation:

* :class:`AxisRules` maps each logical name to the mesh axes it shards
  over (a name, a tuple of names for multi-axis groups like FSDP over
  ``("pod", "data")``, or ``None`` for replicated).
* :data:`DEFAULT_RULES` is the reference's production table: batch and the
  parameters' d_model dim over the data-parallel axes (FSDP/ZeRO-3),
  heads / d_ff / vocab / experts over "model" (tensor parallel), and the
  sequence-parallel residual layout ("seq_sp" → "model").
* :func:`axis_rules` swaps the active table for the dynamic extent of a
  block; experiments override single rules without touching model code.
* :func:`use_mesh` installs a :class:`~torch.distributed.device_mesh.DeviceMesh`
  for the block (the reference reads jax's ``with mesh:`` instead);
  :func:`current_mesh` reads it.
* :func:`constrain` redistributes a DTensor activation to the placements
  the active rules give its logical axes **iff a mesh is active**; with no
  mesh it returns its argument, the same object, so single-device paths
  pay nothing.  Non-divisible dims degrade to replication.
* :func:`divisible_spec` is that degradation as a helper, which
  :mod:`repro_torch.launch.sharding` uses for parameter and cache specs.

A spec has the reference's form, one entry per tensor dim: ``None``, a
mesh-axis name, or a tuple of names (major first).  :func:`placements`
turns it into DTensor placements, one per mesh dim: a tensor dim named by
a mesh axis is ``Shard(dim)`` on that mesh dim, every other mesh dim is
``Replicate()``.  A group entry such as ``("pod", "data")`` on one tensor
dim is ``Shard(dim)`` on both mesh dims; DTensor splits a dim sharded over
several mesh dims in mesh-dim order, the first mesh dim major, so a group
must name its axes in the mesh's order (the reference's major-to-minor
order), and one that does not raises.

Rules consult only ``mesh.axis_names`` / ``mesh.shape`` (a DeviceMesh
gives them as ``mesh_dim_names`` / ``shape``; :func:`mesh_sizes` reads
either), so a 1-device mesh, the 32×8 production layout and the 2×32×8
multi-pod one resolve from one table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "axis_rules",
    "carry",
    "constrain",
    "current_mesh",
    "current_rules",
    "divisible_spec",
    "mesh_axis_names",
    "mesh_sizes",
    "on_local_blocks",
    "placements",
    "replicate",
    "resolved_placements",
    "use_mesh",
    "whole",
]

# A rule's right-hand side: replicated, one mesh axis, or an ordered group
# of mesh axes (major → minor, e.g. FSDP over ("pod", "data")).
MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


def mesh_axis_names(mesh: Any) -> Tuple[str, ...]:
    """The axis names of a DeviceMesh (``mesh_dim_names``) or of any object
    with ``axis_names`` (a jax mesh, a test's stand-in)."""
    names = getattr(mesh, "axis_names", None)
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names or ())


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis name: extent}``: a DeviceMesh's ``shape`` is a tuple, a jax
    mesh's (and a test stand-in's) a mapping."""
    shape = getattr(mesh, "shape", None)
    if shape is None:
        return {}
    if isinstance(shape, Mapping):
        return {k: int(v) for k, v in shape.items()}
    return dict(zip(mesh_axis_names(mesh), (int(n) for n in shape)))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Immutable logical-name → mesh-axes table.

    The table is total over the names the models use; unknown names
    resolve to replicated (None), so a new logical axis degrades
    gracefully until a rule is written for it.
    """

    table: Mapping[str, MeshAxes]

    def mesh_axes(self, logical: str, axis_names: Sequence[str]) -> MeshAxes:
        """Resolve one logical name against the axes a mesh actually has.

        Group rules keep only present axes — ("pod", "data") degrades to
        "data" on a single-pod mesh — and a rule with no surviving axis
        (or an unknown name) resolves to None (replicated).
        """
        want = self.table.get(logical)
        if want is None:
            return None
        if isinstance(want, str):
            want = (want,)
        present = tuple(a for a in want if a in tuple(axis_names))
        if not present:
            return None
        return present[0] if len(present) == 1 else present

    def spec(self, logical_axes: Sequence[Optional[str]], mesh: Any) -> Spec:
        """Spec for a tuple of logical names on ``mesh``.

        A mesh axis is consumed at most once per spec: when two dims map
        to the same axis — ("d_ff", "vocab") both → "model" — the first dim
        keeps it and later dims drop it (replicated), the "first dim wins"
        convention of t5x/flax logical partitioning.
        """
        names = mesh_axis_names(mesh)
        used: set = set()
        parts = []
        for logical in logical_axes:
            if logical is None:
                parts.append(None)
                continue
            axes = self.mesh_axes(logical, names)
            if axes is None:
                parts.append(None)
                continue
            group = (axes,) if isinstance(axes, str) else axes
            group = tuple(a for a in group if a not in used)
            if not group:
                parts.append(None)
                continue
            used.update(group)
            parts.append(group[0] if len(group) == 1 else group)
        return tuple(parts)

    def extend(self, **overrides: MeshAxes) -> "AxisRules":
        """A new table with ``overrides`` replacing / adding rules."""
        merged = dict(self.table)
        merged.update(overrides)
        return AxisRules(table=merged)


# Production layout (rationale in the module docstring):
#   dp / FSDP group  — batch and parameter d_model over ("pod", "data")
#   tensor parallel  — head-, ff-, vocab- and expert-sharded dims → "model"
#   sequence parallel— the residual's seq dim → "model" between TP regions
#   replicated       — per-layer stack dims, norm weights, tiny vectors
DEFAULT_RULES = AxisRules(
    table={
        # data-parallel / FSDP group
        "batch": ("pod", "data"),
        "embed": ("pod", "data"),
        # tensor-parallel dims
        "heads": "model",
        "kv_heads": "model",
        "d_ff": "model",
        "vocab": "model",
        "experts": "model",
        "conv_dim": "model",
        "ssm_heads": "model",
        # sequence-parallel residual layout (Megatron SP)
        "seq_sp": "model",
        # replicated
        "seq": None,
        "embed_act": None,
        "expert_ff": None,
        "layers": None,
        "block_pos": None,
        "frames": None,
    }
)


class _Local(threading.local):
    def __init__(self):
        self.rules: list = []
        self.meshes: list = []


_STATE = _Local()


def current_rules() -> AxisRules:
    """The innermost :func:`axis_rules` table, or :data:`DEFAULT_RULES`."""
    return _STATE.rules[-1] if _STATE.rules else DEFAULT_RULES


@contextlib.contextmanager
def axis_rules(rules: Union[AxisRules, Mapping[str, MeshAxes]]) -> Iterator[AxisRules]:
    """Install a rule table for the dynamic extent of the block.

    Accepts a full :class:`AxisRules` or a mapping of overrides applied on
    top of the currently active table::

        with axis_rules({"seq_sp": None}):   # no sequence parallelism
            loss, _ = api.loss(model, batch)
    """
    if not isinstance(rules, AxisRules):
        rules = current_rules().extend(**dict(rules))
    _STATE.rules.append(rules)
    try:
        yield rules
    finally:
        _STATE.rules.pop()


def whole(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor holding all of it: a DTensor is gathered
    (every rank of its mesh takes part), a plain tensor is ``t``."""
    full = getattr(t, "full_tensor", None)
    return full() if full is not None else t


def current_mesh():
    """The mesh installed by the innermost :func:`use_mesh`, or None."""
    return _STATE.meshes[-1] if _STATE.meshes else None


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[Any]:
    """Make ``mesh`` the active mesh for the block (``None`` installs
    nothing: the single-device path)."""
    if mesh is None:
        yield None
        return
    _STATE.meshes.append(mesh)
    try:
        yield mesh
    finally:
        _STATE.meshes.pop()


def replicate(t: torch.Tensor) -> torch.Tensor:
    """A tensor made inside a mesh block (positions, a mask, a zero
    accumulator), the same on every rank, as a DTensor replicated over the
    active mesh; ``t`` itself without a mesh.  Such tensors are the only
    plain ones a mesh path may bring to DTensor: any other that meets a
    DTensor raises there."""
    mesh = current_mesh()
    if mesh is None:
        return t
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def carry():
    """A context manager factory that re-installs, in whatever thread enters
    it, the mesh and the rule table active where ``carry()`` was called.
    Autograd runs a CUDA backward, and with it a block that
    ``models.common.remat`` recomputes, on a thread of its own: the thread
    gets the caller's ATen thread-local state but not :func:`use_mesh`'s
    Python thread-local stack, which the recomputed block reads."""
    mesh, rules = current_mesh(), current_rules()

    @contextlib.contextmanager
    def enter():
        with axis_rules(rules), use_mesh(mesh):
            yield

    return enter


def _entry_divisible(entry: MeshAxes, dim: int, sizes: Mapping[str, int]) -> MeshAxes:
    """Shrink one spec entry until its axis-size product divides ``dim``.

    Group entries drop minor axes first (keep the longest divisible major
    prefix); a single axis either fits or is dropped entirely.
    """
    if entry is None:
        return None
    group = (entry,) if isinstance(entry, str) else tuple(entry)
    while group:
        n = 1
        for a in group:
            n *= int(sizes.get(a, 1))
        if n > 0 and dim % n == 0 and dim >= n:
            break
        group = group[:-1]
    if not group:
        return None
    return group[0] if len(group) == 1 else group


def divisible_spec(spec: Sequence[Any], shape: Sequence[int], mesh: Any) -> Spec:
    """Replication fallback: drop spec entries that don't divide the shape.

    ``spec`` entries are mesh-axis names (or axis groups) positionally
    matched with ``shape``; any dim whose assigned axes' total extent does
    not divide it falls back to None (12 heads on a model=16 mesh stay
    replicated, where an uneven shard would pad).
    """
    dims = tuple(shape)
    sizes = mesh_sizes(mesh)
    entries = tuple(spec)[: len(dims)]
    return tuple(_entry_divisible(e, dims[i], sizes) for i, e in enumerate(entries))


def placements(spec: Sequence[MeshAxes], mesh: Any) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(i)`` where tensor dim ``i`` names that mesh axis and the axis
    spans more than one rank, else ``Replicate()`` (see the module
    docstring for groups).  So every placement on a 1×1 mesh is
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_sizes(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise NotImplementedError(
                f"spec entry {entry!r} names its axes out of the mesh's order "
                f"{names}: DTensor shards one dim over several mesh dims "
                "major-first in mesh order"
            )
        for j in dims:
            if sizes[names[j]] > 1:   # a shard over one rank is the whole dim
                out[j] = Shard(i)
    return tuple(out)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` laid out as the active rules give these axes.

    Identity (the same object) when no mesh is active.  Under a mesh,
    resolves the logical names through :func:`current_rules`, degrades
    non-divisible dims to replication and redistributes the DTensor ``x``
    to those placements; fewer names than ``x.ndim`` leaves trailing dims
    replicated, and a spec of all ``None`` leaves ``x`` as it is, as the
    reference's ``with_sharding_constraint`` is skipped.  A plain tensor
    under a mesh raises: an activation that has left DTensor is a fault to
    find, not to hide.
    """
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{logical_axes}: a plain {type(x).__name__} of shape "
            f"{tuple(x.shape)} under a mesh; every activation on a mesh path "
            "is a DTensor"
        )
    spec = divisible_spec(current_rules().spec(logical_axes, mesh), x.shape, mesh)
    if all(entry is None for entry in spec):
        return x
    want = placements(spec, mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def on_local_blocks(fn, in_placements: Sequence, out_placements):
    """``fn`` over each rank's local blocks of the active mesh (DTensor's
    ``local_map``): its DTensor arguments are first laid out by
    ``in_placements`` (one per argument, None for a non-tensor), and what
    it returns is read as laid out by ``out_placements`` (a tuple of
    placements for one output, a list of such tuples for several).
    Gradients flow back the same way; where the work is split along a mesh
    dim (some argument is sharded there), an argument whole along it gets
    a partial gradient on each rank, summed over the dim."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    # local_map reads a tuple as one placement list per output
    outs = (tuple(list(p) for p in out_placements) if isinstance(out_placements, list)
            else list(out_placements))
    ins = tuple(None if p is None else list(p) for p in in_placements)
    # the work is split along a mesh dim where some argument is sharded: an
    # argument whole there gets only this rank's part of its gradient
    split = {j for p in ins if p is not None for j, q in enumerate(p) if q.is_shard()}
    grads = tuple(None if p is None else
                  [Partial("sum") if j in split and q.is_replicate() else q
                   for j, q in enumerate(p)] for p in ins)
    return local_map(fn, out_placements=outs, in_placements=ins,
                     in_grad_placements=grads, device_mesh=current_mesh(),
                     redistribute_inputs=True)


def resolved_placements(logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                        mesh: Any) -> tuple:
    """Placements of a tensor of ``shape`` whose leading dims carry
    ``logical_axes`` under the active rules, non-divisible dims
    replicated: what :func:`constrain` would lay it out as."""
    spec = divisible_spec(current_rules().spec(logical_axes, mesh), shape, mesh)
    return placements(spec, mesh)
