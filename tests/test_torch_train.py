"""The port's training pieces against the reference's, on the CPU: the
gradient compressors, AdamW, ``chunked_xent`` and every family's loss.

* ``quantize_int8``, ``dequantize_int8``, ``topk_mask`` and the three
  error-feedback compressors: bit for bit on identical inputs, a zero leaf
  and the per-channel fallback on vectors included, and on stacked leaves
  (the reference compresses a parameter stacked over its layers as one
  leaf; the port takes the same leaves through ``reference_layout``).
* ``adamw_update``: within 1e-6 of the reference's for one step, with
  ``m`` in float32 and in bfloat16, clipped and not.
* ``chunked_xent``, ``lm_loss`` (dense, MoE with its aux loss, VLM with
  ``patch_embeds``), ``ssm_loss`` and ``hybrid_loss``: within 1e-5 of the
  reference's on the f32 smoke configs, weights carried across by the
  parameter bridge, and gradients reaching every parameter the
  reference's reach.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.dist import compress as RC
from repro.models.common import chunked_xent as r_chunked_xent
from repro.models.registry import build_model as r_build_model
from repro.train import optimizer as RO
from repro_torch.configs import get_config
from repro_torch.dist import compress as PC
from repro_torch.models.common import chunked_xent
from repro_torch.models.registry import build_model
from repro_torch.models.weights import named_to_reference, params_from_reference
from repro_torch.train import optimizer as PO


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

QUANT_SHAPES = [(128, 64), (1000,), (64, 32, 8), (1,), (3, 1)]


@pytest.mark.parametrize("shape", QUANT_SHAPES)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("zero", [False, True])
def test_quantize_int8_bit_for_bit(shape, per_channel, zero):
    rng = np.random.default_rng(len(shape) + 3 * per_channel)
    x = (rng.standard_normal(shape) * rng.lognormal(size=shape)).astype(np.float32)
    if zero:
        x[...] = 0.0
    q, s = PC.quantize_int8(torch.from_numpy(x), per_channel=per_channel)
    rq, rs = RC.quantize_int8(jnp.asarray(x), per_channel=per_channel)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    back = PC.dequantize_int8(q, s)
    np.testing.assert_array_equal(back.numpy(), np.asarray(RC.dequantize_int8(rq, rs)))
    assert np.all(np.isfinite(back.numpy()))
    if len(shape) < 2 or not per_channel:
        assert s.ndim == 0  # vectors fall back to one scale


@pytest.mark.parametrize("frac", [0.1, 0.5, 1e-6])
def test_topk_mask_bit_for_bit(frac):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((40, 25)).astype(np.float32)
    x[3, :5] = x[0, 0]  # ties at the threshold are kept by both
    np.testing.assert_array_equal(PC.topk_mask(torch.from_numpy(x), frac).numpy(),
                                  np.asarray(RC.topk_mask(jnp.asarray(x), frac)))


@pytest.mark.parametrize("name", ["int8_ef", "int8_pc_ef", "topk_ef"])
@pytest.mark.parametrize("stacked", [False, True])
def test_compressors_bit_for_bit(name, stacked):
    """Four steps of error feedback; ``stacked`` compresses each layer pair
    as one reference leaf ``(2, ...)``, as the train step does."""
    rng = np.random.default_rng(11)
    shapes = {"w": (16, 8), "b": (8,), "z": (4, 4)}
    ours, ref = PC.make_compressor(name), RC.make_compressor(name)
    layers = 2 if stacked else 1
    leaves = ({n: ((layers,), [f"{n}.{i}" for i in range(layers)]) for n in shapes}
              if stacked else None)
    names = [f"{n}.{i}" for n in shapes for i in range(layers)] if stacked else list(shapes)
    shape_of = lambda n: shapes[n.split(".")[0]]
    state = {"ef_residual": ours.init({n: torch.zeros(shape_of(n)) for n in names})}
    r_state = {"ef_residual": ref.init(
        {n: jnp.zeros((layers,) * stacked + s) for n, s in shapes.items()})}
    for step in range(4):
        g = {n: rng.standard_normal(shape_of(n)).astype(np.float32) * 10.0 ** -step
             for n in names}
        for n in names:
            if n.startswith("z"):
                g[n][...] = 0.0  # a zero leaf: scale floor, no NaN
        cg, state = ours.apply({n: torch.from_numpy(v) for n, v in g.items()}, state,
                               leaves)
        if stacked:
            rg = {n: jnp.asarray(np.stack([g[f"{n}.{i}"] for i in range(layers)]))
                  for n in shapes}
        else:
            rg = {n: jnp.asarray(v) for n, v in g.items()}
        rcg, r_state = ref.apply(rg, r_state)
        for n in shapes:
            got = (np.stack([_np(cg[f"{n}.{i}"]) for i in range(layers)]) if stacked
                   else _np(cg[n]))
            res = (np.stack([_np(state["ef_residual"][f"{n}.{i}"]) for i in range(layers)])
                   if stacked else _np(state["ef_residual"][n]))
            np.testing.assert_array_equal(got, np.asarray(rcg[n]))
            np.testing.assert_array_equal(res, np.asarray(r_state["ef_residual"][n]))
            assert np.all(np.isfinite(got))


def test_make_compressor_names():
    assert PC.make_compressor(None) is None and PC.make_compressor("none") is None
    assert PC.make_compressor("int8_pc_ef").per_channel
    assert PC.make_compressor("topk_ef", topk_frac=0.3).topk_frac == 0.3
    with pytest.raises(ValueError):
        PC.make_compressor("fp4")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
@pytest.mark.parametrize("count", [0, 7, 150])
def test_adamw_update_matches_reference(m_dtype, clip, count):
    rng = np.random.default_rng(count + int(clip))
    shapes = {"a": (32, 16), "b": (16,), "c": (3, 4, 5)}
    p = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
    m = {n: (0.1 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}
    v = {n: (0.01 * rng.random(s)).astype(np.float32) for n, s in shapes.items()}
    kw = dict(warmup_steps=10, total_steps=200, grad_clip=clip, m_dtype=m_dtype)
    ours = PO.AdamWConfig(**kw)
    mdt = torch.bfloat16 if m_dtype == "bfloat16" else torch.float32
    jdt = jnp.bfloat16 if m_dtype == "bfloat16" else jnp.float32
    opt = PO.adamw_init({n: torch.from_numpy(x) for n, x in p.items()}, ours)
    for n in shapes:
        opt["m"][n].copy_(torch.from_numpy(m[n]).to(mdt))
        opt["v"][n].copy_(torch.from_numpy(v[n]))
    opt["count"] = torch.tensor(count, dtype=torch.int32)
    params = {n: torch.from_numpy(x.copy()) for n, x in p.items()}
    params, opt, info = PO.adamw_update(ours, {n: torch.from_numpy(x) for n, x in g.items()},
                                        opt, params)
    r_opt = {"m": {n: jnp.asarray(x).astype(jdt) for n, x in m.items()},
             "v": {n: jnp.asarray(x) for n, x in v.items()},
             "count": jnp.asarray(count, jnp.int32)}
    r_params, r_opt, r_info = RO.adamw_update(RO.AdamWConfig(**kw),
                                              {n: jnp.asarray(x) for n, x in g.items()},
                                              r_opt, {n: jnp.asarray(x) for n, x in p.items()})
    assert int(opt["count"]) == int(r_opt["count"]) == count + 1
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(info[k]), float(r_info[k]), rtol=1e-6)
    for n in shapes:
        assert opt["m"][n].dtype == mdt
        np.testing.assert_allclose(params[n].numpy(), np.asarray(r_params[n]), atol=1e-6)
        np.testing.assert_allclose(opt["m"][n].float().numpy(),
                                   np.asarray(r_opt["m"][n].astype(jnp.float32)),
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(opt["v"][n].numpy(), np.asarray(r_opt["v"][n]),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 5000, 20000])
def test_cosine_schedule_matches_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=100, total_steps=10_000)
    got = float(PO.cosine_schedule(PO.AdamWConfig(**cfg))(torch.tensor(step)))
    want = float(RO.cosine_schedule(RO.AdamWConfig(**cfg))(jnp.asarray(step)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

LOSS_ARCHS = ["yi-6b", "moonshot-v1-16b-a3b", "internvl2-76b", "mamba2-1.3b",
              "jamba-1.5-large-398b"]


def _pair(arch, seed=0):
    """(reference api, its params, the port's api, a training module
    holding the same float32 values)."""
    rcfg = dataclasses.replace(r_get_config(arch).smoke(), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    rapi = r_build_model(rcfg)
    params, _ = rapi.init(jax.random.PRNGKey(seed))
    named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    model = params_from_reference(cfg, named, "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    return rapi, params, build_model(cfg), model


def _batch(cfg, seed, b=3, s=70):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 259, (b, s)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    batch = {"tokens": toks, "loss_mask": mask}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_reference(arch):
    rapi, params, api, model = _pair(arch)
    batch = _batch(api.cfg, LOSS_ARCHS.index(arch))
    (r_loss, r_metrics), r_grads = jax.value_and_grad(rapi.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = api.loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-5, atol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(metrics[k]), float(r_metrics[k]),
                                   rtol=1e-5, atol=1e-5)
    if api.cfg.family in ("moe", "hybrid"):
        assert float(metrics["aux"]) > 0
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
    got = named_to_reference(model, {n: torch.zeros_like(p) if g is None else g
                                     for (n, p), g in zip(named.items(), grads)})
    want = {n: np.asarray(a) for n, a in _flatten_with_names(r_grads)}
    assert set(got) == set(want)
    for n, w in want.items():
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(got[n].numpy(), w, atol=1e-5 * max(1.0, scale),
                                   rtol=1e-4, err_msg=n)
        assert (np.abs(w).max() == 0) == (float(got[n].abs().max()) == 0), n


@pytest.mark.parametrize("s,chunk", [(70, 512), (70, 16), (64, 32), (5, 2)])
def test_chunked_xent_matches_reference(s, chunk):
    rapi, params, api, model = _pair("yi-6b")
    rng = np.random.default_rng(s + chunk)
    d, v = api.cfg.d_model, api.cfg.vocab_size
    hidden = rng.standard_normal((2, s, d)).astype(np.float32)
    targets = rng.integers(0, v, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) < 0.7).astype(np.float32)
    want = r_chunked_xent(params["embed"], rapi.cfg, jnp.asarray(hidden),
                          jnp.asarray(targets), jnp.asarray(mask), chunk=chunk)
    h = torch.from_numpy(hidden).requires_grad_(True)
    got = chunked_xent(model.embed, api.cfg, h, torch.from_numpy(targets),
                       torch.from_numpy(mask), chunk=chunk)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-5)
    r_dh = jax.grad(lambda x: r_chunked_xent(params["embed"], rapi.cfg, x,
                                             jnp.asarray(targets), jnp.asarray(mask),
                                             chunk=chunk))(jnp.asarray(hidden))
    dh, = torch.autograd.grad(got, (h,))
    np.testing.assert_allclose(dh.numpy(), np.asarray(r_dh), atol=1e-6, rtol=1e-4)
    # an all-zero mask divides by 1, not 0
    zero = chunked_xent(model.embed, api.cfg, h, torch.from_numpy(targets),
                        torch.zeros((2, s)), chunk=chunk)
    assert float(zero) == 0.0


def test_ssm_gradient_stays_finite_where_the_reference_overflows():
    """With steps large enough that a chunk's cumulative decay passes
    float32's exp range above the diagonal (dt ~ 8), the reference's
    ``where(causal, exp(cum_q - cum_k), 0)`` has gradient ``0 * inf`` =
    NaN; the port masks the exponent instead: the same loss (1e-5), a
    finite gradient."""
    rapi, params, api, model = _pair("mamba2-1.3b")
    params["blocks"]["mamba"]["dt_bias"] = params["blocks"]["mamba"]["dt_bias"] + 8.0
    with torch.no_grad():
        for layer in model.layers:
            layer.mamba.dt_bias += 8.0
    toks = np.random.default_rng(0).integers(0, 259, (2, 64)).astype(np.int32)
    (r_loss, _), r_grads = jax.value_and_grad(rapi.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks)})
    assert not all(bool(jnp.isfinite(g).all()) for g in jax.tree_util.tree_leaves(r_grads))
    loss, _ = api.loss(model, {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, list(model.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-5)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
