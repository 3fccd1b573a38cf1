"""The transformer family's MoE layers in the port against the reference's,
on the CPU.

The smoke configs of moonshot-v1-16b-a3b (64 experts top-6 cut to 8 top-2)
and qwen3-moe-235b-a22b (GQA with one KV head) in float32.  The reference
draws the weights (``init_lm``), the parameter bridge loads them into the
port, and the same numpy inputs go through both: ``lm_forward`` with its
router aux loss, ``lm_prefill`` on a padded ragged batch (capacity drops
counted over every padded token, as the reference counts them),
``lm_decode_step`` (``no_drop``) and the static engine's greedy tokens.
Values agree within ``atol = rtol = 1e-4``; tokens are identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.models import moe as RM
from repro.models import transformer as R
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.configs import get_config
from repro_torch.models import moe as TM
from repro_torch.models import transformer as T
from repro_torch.models.common import param_count
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference, params_to_reference
from repro_torch.serve.engine import Engine, ServeConfig

TOL = dict(atol=1e-4, rtol=1e-4)
MOE_ARCHS = ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]
PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)",
           "C", "InChI=1S/H2O/h1H2"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


_WEIGHTS = {}


def _weights(arch):
    """(reference cfg, port cfg, reference params, port model), cached."""
    if arch not in _WEIGHTS:
        r_cfg = dataclasses.replace(r_get_config(arch).smoke(), dtype="float32")
        t_cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        params, _ = R.init_lm(r_cfg, jax.random.PRNGKey(11))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[arch] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[arch]


def _tokens(seed, b, s, vocab=259):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_family_builds_with_moe_layers(arch):
    cfg = get_config(arch)
    api = build_model(cfg)
    assert api.supports_paged and api.prefill_suffix is not None
    small = dataclasses.replace(cfg.smoke(), n_layers=2)
    model = build_model(small).init(torch.Generator().manual_seed(0), "cpu")
    layer = model.layers[0]
    assert layer.mlp is None and layer.moe is not None
    assert layer.moe.wg.shape == (8, 128, 256) and layer.moe.wg.dtype == torch.bfloat16
    assert layer.moe.router.dtype == torch.float32
    with pytest.raises(ValueError, match="one of mlp and moe"):
        T.DecoderLayer(layer.ln1, layer.attn, layer.ln2, layer.mlp, None)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_parameter_bridge_round_trips_moe_names(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    want = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    assert {"blocks/moe/router", "blocks/moe/wg", "blocks/moe/wu",
            "blocks/moe/wd"} <= set(want)
    back = params_to_reference(model)
    assert sorted(back) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(back[n], want[n], err_msg=n)
    # and the other way: the port's own init through the reference's names
    own = build_model(t_cfg).init(torch.Generator().manual_seed(2), "cpu")
    again = params_from_reference(t_cfg, params_to_reference(own), device="cpu")
    for a, b in zip(own.parameters(), again.parameters()):
        assert torch.equal(a, b)
    assert param_count(model) == sum(a.size for a in want.values())


def test_bf16_bridge_casts_what_the_reference_casts():
    r_cfg = r_get_config("moonshot-v1-16b-a3b").smoke()
    t_cfg = get_config("moonshot-v1-16b-a3b").smoke()
    params, _ = R.init_lm(r_cfg, jax.random.PRNGKey(0))
    named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    model = params_from_reference(t_cfg, named, device="cpu")
    moe = model.layers[1].moe
    assert moe.router.dtype == torch.float32
    assert {moe.wg.dtype, moe.wu.dtype, moe.wd.dtype} == {torch.bfloat16}
    np.testing.assert_array_equal(
        moe.wd.float().numpy(),
        np.asarray(jnp.asarray(named["blocks/moe/wd"][1]).astype(jnp.bfloat16),
                   np.float32))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_forward_with_aux_matches_reference(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    toks = _tokens(1, 2, 40)
    want, want_aux = R.lm_forward(params, r_cfg, jnp.asarray(toks))
    with torch.no_grad():
        got, aux = T.lm_forward(model, t_cfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def _dropped_reference(params, cfg, x):
    """The reference's dropped-assignment count of one MoE call."""
    t = x.shape[0] * x.shape[1]
    cap = max(1, int(cfg.capacity_factor * t * cfg.experts_per_token / cfg.n_experts))
    p = params
    return int(RM._local_moe(jnp.asarray(x), p["router"], p["wg"], p["wu"], p["wd"],
                             cfg=cfg, e0=0, capacity=cap)[2])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_prefill_ragged_and_decode_match_reference(arch):
    """A right-padded ragged batch (capacity over all padded tokens, so
    assignments drop), every layer's cache, then decode steps (no drop)
    fed the reference's greedy tokens."""
    r_cfg, t_cfg, params, model = _weights(arch)
    b, s, max_len = 3, 48, 80
    toks = _tokens(2, b, s)
    lens = np.array([s, 29, 7], np.int32)
    logits, cache = R.lm_prefill(params, r_cfg, jnp.asarray(toks), max_len=max_len,
                                 lengths=jnp.asarray(lens))
    with TM.monitor(model) as sink:
        t_logits, t_cache = T.lm_prefill(model, t_cfg, _t(toks), max_len=max_len,
                                         lengths=_t(lens).long())
    assert len(sink) == r_cfg.n_layers
    assert int(sum(c.dropped for c in sink)) > 0  # the capacity dropped assignments
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    for layer in range(r_cfg.n_layers):
        np.testing.assert_allclose(t_cache[layer]["k"].numpy(),
                                   np.asarray(cache["pos0"]["k"][layer]), **TOL)
        np.testing.assert_allclose(t_cache[layer]["v"].numpy(),
                                   np.asarray(cache["pos0"]["v"][layer]), **TOL)
    pos = lens.copy()
    for _ in range(6):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.lm_decode_step(params, r_cfg, jnp.asarray(tok),
                                         jnp.asarray(pos), cache)
        with TM.monitor(model) as sink:
            t_logits, t_cache = T.lm_decode_step(model, t_cfg, _t(tok).long(),
                                                 _t(pos).long(), t_cache)
        assert len(sink) == r_cfg.n_layers
        assert int(sum(c.dropped for c in sink)) == 0  # decode never drops
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropped_count_matches_reference(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    # tokens near one direction route alike: their experts overflow
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 1, r_cfg.d_model))
         + 0.3 * rng.standard_normal((2, 40, r_cfg.d_model))).astype(np.float32)
    layer = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["moe"])
    want = _dropped_reference(layer, r_cfg, x)
    with TM.monitor(model.layers[0].moe) as sink:
        TM.moe_apply(model.layers[0].moe, t_cfg, _t(x))
    assert int(sink[0].dropped) == want > 0
    with TM.monitor(model.layers[0].moe) as sink:
        TM.moe_apply(model.layers[0].moe, t_cfg, _t(x), no_drop=True)
    assert int(sink[0].dropped) == 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_monitor_records_the_dispatched_routing(arch):
    """``monitor`` records the routing each call dispatched: the reference
    router's top-k experts and the gap below them, for one model only and
    only inside the block."""
    r_cfg, t_cfg, params, model = _weights(arch)
    other = build_model(t_cfg).init(torch.Generator().manual_seed(1), "cpu")
    x = np.random.default_rng(6).standard_normal((2, 9, r_cfg.d_model)).astype(np.float32)
    layer = model.layers[0].moe
    with TM.monitor(model) as calls:
        TM.moe_apply(layer, t_cfg, _t(x))
        TM.moe_apply(other.layers[0].moe, t_cfg, _t(x))
    assert len(calls) == 1 and layer.monitor is None
    router = np.asarray(params["blocks"]["moe"]["router"][0])
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(-1, r_cfg.d_model)) @ router))
    k = r_cfg.experts_per_token
    top = np.sort(probs, axis=-1)[:, ::-1]
    np.testing.assert_array_equal(np.sort(calls[0].top_i.numpy(), axis=-1),
                                  np.sort(np.argsort(-probs, axis=-1)[:, :k], axis=-1))
    np.testing.assert_allclose(calls[0].margin.numpy(), top[:, k - 1] - top[:, k],
                               atol=1e-6)
    TM.moe_apply(layer, t_cfg, _t(x))
    assert len(calls) == 1  # nothing is kept outside the block


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_identical_to_reference(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=10, max_len=96,
                                               sync_every=4)).generate(PROMPTS)
    got = Engine(t_cfg, model, ServeConfig(max_new_tokens=10, max_len=96,
                                           sync_every=4), device="cpu").generate(PROMPTS)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert got[0].steps == want[0].steps


def test_init_lm_draws_moe_on_the_generator_device():
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").smoke(), n_layers=1)
    a = T.init_lm(cfg, torch.Generator().manual_seed(4), "cpu")
    b = T.init_lm(cfg, torch.Generator().manual_seed(4), "cpu")
    assert torch.equal(a.layers[0].moe.wu, b.layers[0].moe.wu)
    assert a.layers[0].moe.wg.device.type == "cpu"
