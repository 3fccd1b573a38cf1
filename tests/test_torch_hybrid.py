"""The port's MoE layer (its single-device path) and hybrid (Jamba) LM
against the reference's, on the CPU.

Weights are drawn by the reference (``init_hybrid``, ``moe_init``),
flattened under its checkpoint names and loaded into the port by the
parameter bridge; inputs come from numpy seeds.  The config is the reduced
``jamba-1.5-large-398b`` smoke config in float32: one super-block of 4
layers, attention at position 1, Mamba2 at 0, 2 and 3, MoE (8 experts,
top-2) at the odd positions and SwiGLU at the even ones.  Outputs, logits
and caches agree within ``atol = rtol = 1e-4`` and greedy tokens are
identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import (
    _flatten_with_names,
    restore_pytree as r_restore_pytree,
    save_pytree as r_save_pytree,
)
from repro.configs import get_config as r_get_config
from repro.models import hybrid as R
from repro.models import moe as RMoE
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.checkpoint.manager import restore_named, save_pytree
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.models import hybrid as T
from repro_torch.models import moe as TMoE
from repro_torch.models.common import Attention, SwiGLU
from repro_torch.models.mamba2 import Mamba2
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference, params_to_reference
from repro_torch.serve.engine import Engine, ServeConfig

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(r_get_config(ARCH).smoke(), dtype=dtype),
            dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype))


_WEIGHTS = {}


def _weights():
    """(reference cfg, port cfg, reference params, port model), cached."""
    if not _WEIGHTS:
        r_cfg, t_cfg = _cfgs()
        params, _ = R.init_hybrid(r_cfg, jax.random.PRNGKey(13))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS["f32"] = (r_cfg, t_cfg, params,
                           params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS["f32"]


def _tokens(seed, b, s, vocab=259):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# MoE, the local path
# ---------------------------------------------------------------------------

def _moe(seed=3):
    r_cfg, t_cfg = _cfgs()
    p, _ = RMoE.moe_init(jax.random.PRNGKey(seed), r_cfg)
    m = TMoE.MoE(*(torch.from_numpy(np.array(p[n])) for n in ("router", "wg", "wu", "wd")))
    return r_cfg, t_cfg, p, m


@pytest.mark.parametrize("capacity,want_drops", [(1, True), (3, True), (40, False)])
def test_local_moe_outputs_and_drops(capacity, want_drops):
    """Random float32 router probabilities do not tie, so top-k and the
    capacity ranking are the reference's."""
    r_cfg, t_cfg, p, m = _moe()
    x = np.random.default_rng(capacity).standard_normal((2, 20, r_cfg.d_model)).astype(np.float32)
    y, aux, dropped = RMoE._local_moe(
        jnp.asarray(x), p["router"], p["wg"], p["wu"], p["wd"], cfg=r_cfg, e0=0,
        capacity=capacity)
    ty, taux, tdropped = TMoE._local_moe(
        _t(x), m.router, m.wg, m.wu, m.wd, cfg=t_cfg, e0=0, capacity=capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    assert int(tdropped) == int(dropped)
    assert (int(dropped) > 0) == want_drops


def test_local_moe_experts_held_elsewhere():
    """e0 > 0: assignments to experts not held here are neither run nor
    counted as dropped, as in one shard of the reference's expert split."""
    r_cfg, t_cfg, p, m = _moe(4)
    x = np.random.default_rng(8).standard_normal((1, 24, r_cfg.d_model)).astype(np.float32)
    half = {n: p[n][4:] for n in ("wg", "wu", "wd")}
    y, aux, dropped = RMoE._local_moe(jnp.asarray(x), p["router"], half["wg"],
                                      half["wu"], half["wd"], cfg=r_cfg, e0=4,
                                      capacity=2)
    ty, taux, tdropped = TMoE._local_moe(_t(x), m.router, m.wg[4:], m.wu[4:],
                                         m.wd[4:], cfg=t_cfg, e0=4, capacity=2)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    assert int(tdropped) == int(dropped) > 0


@pytest.mark.parametrize("no_drop", [False, True])
def test_moe_apply_parity(no_drop):
    r_cfg, t_cfg, p, m = _moe(5)
    x = np.random.default_rng(6).standard_normal((3, 17, r_cfg.d_model)).astype(np.float32)
    y, aux = RMoE.moe_apply(p, r_cfg, jnp.asarray(x), no_drop=no_drop)
    ty, taux = TMoE.moe_apply(m, t_cfg, _t(x), no_drop=no_drop)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)
    t = 3 * 17
    assert TMoE.capacity_for(t_cfg, t, no_drop) == (t if no_drop else int(1.25 * t * 2 / 8))


def test_moe_apply_over_a_mesh_raises_naming_its_item():
    """moe_apply reads its mesh from use_mesh: a mesh= that is not the
    active one (here none is active) raises, naming where the mesh comes
    from."""
    _, t_cfg, _, m = _moe()
    with pytest.raises(ValueError, match="use_mesh"):
        TMoE.moe_apply(m, t_cfg, torch.zeros((1, 2, t_cfg.d_model)), mesh=object())


# ---------------------------------------------------------------------------
# the hybrid LM
# ---------------------------------------------------------------------------

def test_layout_and_layer_kinds():
    _, t_cfg, _, model = _weights()
    assert T._layout(t_cfg) == (1, 4, [0, 2, 3], [1, 3], [0, 2])
    kinds = [(type(l.mixer), type(l.ffn)) for l in model.layers]
    assert kinds == [(Mamba2, SwiGLU), (Attention, TMoE.MoE),
                     (Mamba2, SwiGLU), (Mamba2, TMoE.MoE)]
    with pytest.raises(ValueError, match="super-blocks"):
        T._layout(dataclasses.replace(t_cfg, n_layers=6))


def test_hybrid_forward_parity():
    r_cfg, t_cfg, params, model = _weights()
    toks = _tokens(1, 2, 45)
    want, aux = R.hybrid_forward(params, r_cfg, jnp.asarray(toks))
    got, taux = T.hybrid_forward(model, t_cfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=1e-5)


def _check_cache(t_cache, r_cache, r_cfg):
    n_blocks, per, mamba_pos, *_ = R._layout(r_cfg)
    assert len(t_cache) == r_cfg.n_layers
    for i, layer in enumerate(t_cache):
        blk, j = divmod(i, per)
        if j == r_cfg.attn_index:
            for n in ("k", "v"):
                np.testing.assert_allclose(layer[n].numpy(),
                                           np.asarray(r_cache["attn"][n][blk]), **TOL)
        else:
            mi = mamba_pos.index(j)
            for n in ("ssm", "conv"):
                np.testing.assert_allclose(layer[n].numpy(),
                                           np.asarray(r_cache["mamba"][n][blk, mi]),
                                           **TOL)


@pytest.mark.parametrize("s,lens", [(50, (50, 29)), (70, (70, 70))])
def test_hybrid_prefill_and_decode_parity(s, lens):
    """Ragged prefill (logits, both caches of every layer), then decode
    steps fed the reference's greedy tokens; one flash_attention and one
    ssd_scan call per attention / Mamba position on the CPU's plain route
    (no kernel launch counted)."""
    r_cfg, t_cfg, params, model = _weights()
    toks = _tokens(s, 2, s)
    lens = np.array(lens, np.int32)
    max_len = 96
    launches = (flash_attention_cuda.launches, ssd_scan_cuda.launches)
    logits, cache = R.hybrid_prefill(params, r_cfg, jnp.asarray(toks), max_len=max_len,
                                     lengths=jnp.asarray(lens))
    t_logits, t_cache = T.hybrid_prefill(model, t_cfg, _t(toks), max_len=max_len,
                                         lengths=_t(lens).long())
    assert (flash_attention_cuda.launches, ssd_scan_cuda.launches) == launches
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    _check_cache(t_cache, cache, r_cfg)
    pos = lens.copy()
    for _ in range(6):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.hybrid_decode_step(params, r_cfg, jnp.asarray(tok),
                                             jnp.asarray(pos), cache)
        t_logits, t_cache = T.hybrid_decode_step(model, t_cfg, _t(tok).long(),
                                                 _t(pos).long(), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    _check_cache(t_cache, cache, r_cfg)


def test_hybrid_cache_init_matches_reference_shapes():
    r_cfg, t_cfg = _cfgs("bfloat16")
    cache, _ = R.hybrid_cache_init(r_cfg, 2, 40)
    t_cache = T.hybrid_cache_init(t_cfg, 2, 40, device="cpu")
    assert t_cache[1]["k"].shape == cache["attn"]["k"].shape[1:]
    assert t_cache[1]["k"].dtype == torch.bfloat16
    assert t_cache[0]["ssm"].shape == cache["mamba"]["ssm"].shape[2:]
    assert t_cache[3]["conv"].shape == cache["mamba"]["conv"].shape[2:]
    assert t_cache[0]["ssm"].dtype == torch.float32
    assert t_cache[0]["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the engine, the launcher, the bridge, checkpoints
# ---------------------------------------------------------------------------

PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)",
           "CC", "InChI=1S/H2O/h1H2"]


def test_engine_greedy_tokens_identical_to_reference():
    r_cfg, t_cfg, params, model = _weights()
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=12, max_len=96,
                                               sync_every=4)).generate(PROMPTS)
    got = Engine(t_cfg, model, ServeConfig(max_new_tokens=12, max_len=96,
                                           sync_every=4), device="cpu").generate(PROMPTS)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert got[0].steps == want[0].steps


def test_serve_launcher_serves_jamba_smoke_on_cpu():
    from repro_torch.launch import serve

    out = serve.run(serve.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--max-new-tokens", "3",
         "--max-len", "32", "--repeats", "2"]))
    assert out["n_layers"] == 4 and out["config"] == "smoke"
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    cfg = get_config(ARCH).smoke()
    kv = 2 * 2 * cfg.n_kv_heads * 32 * cfg.resolved_head_dim * 2     # B=2, k and v
    state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    conv = (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    assert out["kv_cache_bytes"] == kv + 3 * 2 * (state + conv)


def test_init_hybrid_shapes_dtypes_and_seed():
    cfg = get_config(ARCH).smoke()
    api = build_model(cfg)
    m = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    again = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    moe = m.layers[1].ffn
    assert moe.router.dtype == torch.float32 and moe.router.shape == (128, 8)
    assert moe.wg.dtype == torch.bfloat16 and moe.wd.shape == (8, 256, 128)
    assert m.layers[1].mixer.wq.dtype == torch.bfloat16
    assert m.layers[2].mixer.conv_w.dtype == torch.float32
    assert torch.equal(again.layers[3].ffn.wu, m.layers[3].ffn.wu)


def test_parameter_bridge_round_trip():
    r_cfg, t_cfg, params, model = _weights()
    back = params_to_reference(model)
    want = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    assert sorted(back) == sorted(want)
    for n in want:
        assert back[n].shape == want[n].shape, n
        np.testing.assert_array_equal(back[n], want[n], err_msg=n)


def test_checkpoint_cross_restore(tmp_path):
    r_cfg, t_cfg, params, _ = _weights()
    r_save_pytree(params, tmp_path / "ref")
    model = params_from_reference(t_cfg, restore_named(tmp_path / "ref", device="cpu"),
                                  device="cpu")
    save_pytree(params_to_reference(model), tmp_path / "port")
    back = r_restore_pytree(params, tmp_path / "port")
    for (n, a), (_, b) in zip(_flatten_with_names(params), _flatten_with_names(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)
