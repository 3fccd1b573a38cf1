"""The port's logical-axis rules against ``repro.dist.logical``, with no
process group: the rules read only a mesh's axis names and extents, so a
stand-in mesh (``FakeMesh``, as ``tests/test_dist.py`` uses) serves both
packages.  Meshes: (16, 16), (2, 16, 16), (32, 8), (2, 32, 8), (1, 2),
(2, 1) and (4,).

* ``mesh_axes``, ``spec``, ``divisible_spec``, ``extend`` and
  ``axis_rules`` give the reference's answers, entry for entry.
* For every arch, the port's parameter specs (``models.specs``, a full
  config built on ``meta``) equal the reference's (``init`` under
  ``jax.eval_shape``) through the bridge's names, and so do the cache
  specs; resolved on every mesh (``launch.sharding.resolve_spec``, the
  KV-cache fallback included) they equal the reference's
  ``shardings_from_specs``.
* ``constrain`` is the identity, the same object, with no mesh.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.sharding as r_sharding
from repro.configs import get_config as r_get_config
from repro.dist import logical as R
from repro.models.registry import build_model as r_build_model
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import construct_on_meta
from repro_torch.dist import logical as T
from repro_torch.launch.sharding import resolve_spec
from repro_torch.models.registry import build_model
from repro_torch.models.specs import cache_specs, reference_specs


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "32x8": FakeMesh({"data": 32, "model": 8}),
    "2x32x8": FakeMesh({"pod": 2, "data": 32, "model": 8}),
    "1x2": FakeMesh({"data": 1, "model": 2}),
    "2x1": FakeMesh({"data": 2, "model": 1}),
    "4": FakeMesh({"data": 4}),
}
NAMES = sorted(R.DEFAULT_RULES.table) + ["unknown_axis"]
# activation specs the models constrain, and every parameter and cache spec
ACTIVATIONS = [
    ("batch", "seq", "heads", None), ("batch", "seq_sp", None), ("batch", "seq", None),
    ("batch", "seq", "d_ff"), ("batch", "seq", "vocab"), (None, "embed"),
    ("batch", "seq", "conv_dim"), ("batch", "heads", None, None),
    ("batch", "heads", "kv_heads"), ("d_ff", "vocab"), ("layers", "block_pos", "batch"),
]
SHAPES = [(32, 12), (3, 5), (2, 7), (64, 4096), (16, 1, 128), (512, 8, 64, 32),
          (1, 1), (128, 2048, 4352)]


def _tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mesh_axes_matches_reference(mesh):
    names = MESHES[mesh].axis_names
    for n in NAMES:
        assert T.DEFAULT_RULES.mesh_axes(n, names) == R.DEFAULT_RULES.mesh_axes(n, names), n
    assert T.DEFAULT_RULES.table == R.DEFAULT_RULES.table


def _all_specs():
    out = set(ACTIVATIONS)
    for arch in ARCH_NAMES:
        out.update(_ref_param_specs(arch).values())
    return sorted(out, key=str)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_matches_reference(mesh):
    m = MESHES[mesh]
    for logical in _all_specs():
        assert T.DEFAULT_RULES.spec(logical, m) == _tuple(R.DEFAULT_RULES.spec(logical, m)), \
            logical


@pytest.mark.parametrize("mesh", list(MESHES))
def test_divisible_spec_matches_reference(mesh):
    m = MESHES[mesh]
    for logical in _all_specs():
        spec = R.DEFAULT_RULES.spec(logical, m)
        for shape in SHAPES:
            dims = (shape * 2)[: len(spec)] if len(shape) < len(spec) else shape
            assert T.divisible_spec(tuple(spec), dims, m) == \
                _tuple(R.divisible_spec(spec, dims, m)), (logical, dims)


@pytest.mark.parametrize("overrides", [
    {"seq_sp": None}, {"experts": None, "custom": "model"},
    {"batch": ("data",), "embed": None}, {"heads": ("pod", "model")},
])
def test_extend_and_axis_rules_match_reference(overrides):
    t_ext, r_ext = T.DEFAULT_RULES.extend(**overrides), R.DEFAULT_RULES.extend(**overrides)
    assert t_ext.table == r_ext.table
    with T.axis_rules(overrides) as t_rules, R.axis_rules(overrides) as r_rules:
        assert T.current_rules() is t_rules and R.current_rules() is r_rules
        assert t_rules.table == r_rules.table
        for m, n in itertools.product(MESHES.values(), NAMES):
            assert t_rules.mesh_axes(n, m.axis_names) == r_rules.mesh_axes(n, m.axis_names)
    assert T.current_rules() is T.DEFAULT_RULES


# ---------------------------------------------------------------------------
# the models' specs
# ---------------------------------------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, tuple):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


_REF_CACHE = {}


def _ref_param_specs(arch):
    if arch not in _REF_CACHE:
        api = r_build_model(r_get_config(arch))
        box = {}

        def trace(key):
            params, specs = api.init(key)
            box["specs"] = specs
            return params

        shapes = jax.eval_shape(trace, jax.ShapeDtypeStruct((2,), jnp.uint32))
        flat_shapes = {n: tuple(a.shape) for n, a in _flatten_arrays(shapes).items()}
        _REF_CACHE[arch] = (_flatten(box["specs"]), flat_shapes)
    return _REF_CACHE[arch][0]


def _flatten_arrays(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten_arrays(v, f"{prefix}/{k}" if prefix else k))
    return out


def _port_model(arch):
    with construct_on_meta():
        return build_model(get_config(arch)).init(torch.Generator(), "cpu")


@pytest.fixture(scope="module")
def port_models():
    return {}


def _model(port_models, arch):
    if arch not in port_models:
        port_models[arch] = _port_model(arch)
    return port_models[arch]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, port_models):
    assert reference_specs(_model(port_models, arch)) == _ref_param_specs(arch)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_resolved_param_specs_equal_the_reference(arch, port_models, monkeypatch):
    monkeypatch.setattr(r_sharding, "NamedSharding", lambda mesh, spec: spec)
    model = _model(port_models, arch)
    ref_specs = _ref_param_specs(arch)
    ref_shapes = _REF_CACHE[arch][1]
    from repro_torch.models.specs import param_specs
    from repro_torch.models.weights import reference_layout

    mine = param_specs(model)
    shapes = dict((n, tuple(p.shape)) for n, p in model.named_parameters())
    for mesh in MESHES.values():
        want = r_sharding.shardings_from_specs(
            mesh, ref_specs, {n: jax.ShapeDtypeStruct(s, jnp.float32)
                              for n, s in ref_shapes.items()})
        for ref, (lead, names) in reference_layout(model).items():
            w = _tuple(want[ref])[len(lead):]
            w = w + (None,) * (len(shapes[names[0]]) - len(w))
            for n in names:
                got = resolve_spec(mesh, mine[n], shapes[n])
                assert got == w, (ref, n, mesh.shape)


def _ref_cache(arch, batch, max_len, paged=False):
    api = r_build_model(r_get_config(arch))
    box = {}

    def trace():
        if paged:
            cache, spec = api.paged_cache_init(batch, max_len)
        else:
            cache, spec = api.cache_init(batch, max_len)
        box["spec"] = spec
        return cache

    shapes = jax.eval_shape(trace)
    return _flatten(box["spec"]), {n: tuple(a.shape) for n, a in
                                   _flatten_arrays(shapes).items()}


def _port_cache(arch, batch, max_len, paged=False):
    api = build_model(get_config(arch))
    with construct_on_meta():
        if paged:
            return api, api.paged_cache_init(batch, max_len, "cpu")
        return api, api.cache_init(batch, max_len, "cpu")


def _cache_pairs(arch, batch=8, max_len=64, paged=False):
    """(reference name, reference spec, its stack dims, port spec, port
    shape) for every tensor of ``arch``'s cache."""
    from repro_torch.models.hybrid import _layout
    from repro_torch.models.transformer import layer_windows

    ref_specs, ref_shapes = _ref_cache(arch, batch, max_len, paged)
    api, cache = _port_cache(arch, batch, max_len, paged)
    specs = cache_specs(cache)
    cfg = api.cfg
    out = []
    if cfg.family == "encdec":
        for part in ("self", "cross"):
            for name in ("k", "v"):
                ref = f"{part}/{name}"
                out.append((ref, ref_specs[ref], 0, specs[part][name],
                            tuple(cache[part][name].shape)))
        return out, ref_shapes
    for i, (layer_spec, layer) in enumerate(zip(specs, cache)):
        for name, spec in layer_spec.items():
            if cfg.family == "ssm":
                ref, lead = name, 1
            elif cfg.family == "hybrid":
                ref, lead = (f"attn/{name}", 1) if name in ("k", "v") else (f"mamba/{name}", 2)
            else:
                per = len(layer_windows(cfg))
                ref, lead = f"pos{i % per}/{name}", 1
            out.append((ref, ref_specs[ref], lead, spec, tuple(layer[name].shape)))
    return out, ref_shapes


def _cache_cases():
    cases = [(a, False) for a in ARCH_NAMES]
    cases += [(a, True) for a in ARCH_NAMES
              if get_config(a).family in ("dense", "moe", "vlm") and
              get_config(a).local_block == 0]
    return cases


@pytest.mark.parametrize("arch,paged", _cache_cases())
def test_cache_specs_equal_the_reference(arch, paged):
    pairs, _ = _cache_pairs(arch, paged=paged)
    assert pairs
    for ref, want, lead, got, _ in pairs:
        assert want[:lead] in ((), ("layers",), ("layers", "block_pos"))
        assert got == want[lead:], (ref, got, want)


@pytest.mark.parametrize("arch,paged", _cache_cases())
def test_resolved_cache_specs_equal_the_reference(arch, paged, monkeypatch):
    """With the KV fallback: where kv_heads cannot take "model", the
    cache's sequence dim takes it (both packages)."""
    monkeypatch.setattr(r_sharding, "NamedSharding", lambda mesh, spec: spec)
    pairs, ref_shapes = _cache_pairs(arch, paged=paged)
    ref_specs = {ref: want for ref, want, *_ in pairs}
    for mesh in MESHES.values():
        want_all = r_sharding.shardings_from_specs(
            mesh, ref_specs, {n: jax.ShapeDtypeStruct(ref_shapes[n], jnp.float32)
                              for n in ref_specs})
        for ref, _, lead, spec, shape in pairs:
            w = _tuple(want_all[ref])
            w = (w + (None,) * (len(ref_shapes[ref]) - len(w)))[lead:]
            assert resolve_spec(mesh, spec, shape) == w, (ref, mesh.shape)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_and_state_shardings_match_reference(mesh, monkeypatch):
    """The reference's NamedShardings, read back as specs and laid out as
    placements, are the port's placements; a batch that does not divide
    the dp extent stays replicated."""
    from repro_torch.launch.sharding import batch_shardings, replicated, state_shardings

    monkeypatch.setattr(r_sharding, "NamedSharding", lambda mesh, spec: spec)
    m = MESHES[mesh]
    batch = {"tokens": (8, 16), "lengths": (8,), "one": (1, 16), "odd": (3, 5)}
    want = r_sharding.batch_shardings(
        m, {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()})
    got = batch_shardings(m, {k: torch.empty(v, device="meta") for k, v in batch.items()})
    for k in batch:
        assert got[k] == T.placements(tuple(want[k]), m), k
    specs = _ref_param_specs("moonshot-v1-16b-a3b")
    r_state = r_sharding.state_shardings(m, specs)
    state = state_shardings(m, specs)
    for part in (state["params"], state["opt"]["m"], state["opt"]["v"]):
        for n in specs:
            assert part[n] == T.placements(tuple(r_state["params"][n]), m), n
    assert state["step"] == state["opt"]["count"] == replicated(m) == \
        T.placements(tuple(r_state["step"]), m)


def test_constrain_is_identity_without_mesh():
    assert T.current_mesh() is None
    x = torch.arange(12.0).reshape(3, 4)
    assert T.constrain(x, "batch", "d_ff") is x
    with T.use_mesh(None):
        assert T.constrain(x, "batch", "d_ff") is x
