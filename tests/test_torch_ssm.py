"""The port's SSM path (the ``ssd_scan`` kernel's plain version, the Mamba2
mixer, the mamba2 LM, its engine) against the reference's, on the CPU.

Weights are drawn by the reference (``init_ssm``), flattened under its
checkpoint names and loaded into the port by the parameter bridge
(``models/weights.py``); inputs come from numpy seeds.  The config is the
reduced ``mamba2-1.3b`` smoke config in float32 (4 layers, d_model 128,
8 SSD heads of 32, state 32, chunk 32), where both packages do the same
float32 arithmetic in another order: outputs, logits and states agree
within ``atol = rtol = 1e-4`` and greedy tokens are identical.  The plain
``ssd_scan`` is held to the reference's oracle and its Pallas kernel in
interpret mode within 1e-6 (``tests/test_kernels.py``'s cases).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint.manager import (
    _flatten_with_names,
    restore_pytree as r_restore_pytree,
    save_pytree as r_save_pytree,
)
from repro.configs import get_config as r_get_config
from repro.kernels.ssd_scan.kernel import ssd_scan_pallas
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models import mamba2 as RM
from repro.models import ssm as R
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.checkpoint.manager import restore_named, save_pytree
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import mamba2 as M
from repro_torch.models import ssm as T
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference, params_to_reference
from repro_torch.serve.engine import Engine, ServeConfig

TOL = dict(atol=1e-4, rtol=1e-4)
ARCH = "mamba2-1.3b"
# the cases of tests/test_kernels.py: (BH, C, P, N)
SSD_CASES = [(2, 4, 8, 16), (6, 16, 64, 128), (1, 1, 4, 4), (3, 32, 16, 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread, so the workers beside this one
    keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


_WEIGHTS = {}


def _weights(dtype="float32"):
    """(reference cfg, port cfg, reference params, port model), cached."""
    if dtype not in _WEIGHTS:
        r_cfg = dataclasses.replace(r_get_config(ARCH).smoke(), dtype=dtype)
        t_cfg = dataclasses.replace(get_config(ARCH).smoke(), dtype=dtype)
        params, _ = R.init_ssm(r_cfg, jax.random.PRNGKey(11))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[dtype] = (r_cfg, t_cfg, params,
                           params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[dtype]


def _tokens(seed, b, s, vocab=259):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _layer_params(params, i):
    return jax.tree_util.tree_map(lambda v: v[i], params["blocks"]["mamba"])


# ---------------------------------------------------------------------------
# ssd_scan: the plain version against the reference and the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,c,p,n", SSD_CASES)
def test_ssd_scan_plain_matches_ref_and_pallas(bh, c, p, n):
    rng = np.random.default_rng(bh * 10 + c)
    states = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    decay = rng.uniform(0.2, 0.99, (bh, c)).astype(np.float32)
    got = ssd_scan(_t(states), _t(decay))
    assert got.dtype == torch.float32 and got.shape == (bh, c, p, n)
    ref = np.asarray(jax_ssd_scan_ref(jnp.asarray(states), jnp.asarray(decay)))
    pal = np.asarray(ssd_scan_pallas(jnp.asarray(states), jnp.asarray(decay),
                                     interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), pal, atol=1e-6)


def test_ssd_scan_prefix_semantics():
    """prefix[0] == 0 and prefix[c+1] == decay[c]*prefix[c] + states[c],
    as one multiply and one add in float32 (what the kernel does)."""
    rng = np.random.default_rng(17)
    states = torch.from_numpy(rng.standard_normal((2, 5, 4, 4)).astype(np.float32))
    decay = torch.from_numpy(rng.uniform(0.5, 0.9, (2, 5)).astype(np.float32))
    pre = ssd_scan_ref(states, decay)
    assert torch.equal(pre[:, 0], torch.zeros_like(pre[:, 0]))
    for c in range(4):
        want = decay[:, c, None, None] * pre[:, c] + states[:, c]
        assert torch.equal(pre[:, c + 1], want)


@settings(max_examples=20, deadline=None)
@given(
    bh=st.integers(1, 4),
    c=st.integers(1, 12),
    p=st.sampled_from([4, 8]),
    n=st.sampled_from([4, 16]),
    seed=st.integers(0, 2**31 - 1),
)
def test_ssd_scan_property(bh, c, p, n, seed):
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    decay = rng.uniform(0.0, 1.0, (bh, c)).astype(np.float32)
    np.testing.assert_allclose(
        ssd_scan(_t(states), _t(decay)).numpy(),
        np.asarray(ssd_scan_pallas(jnp.asarray(states), jnp.asarray(decay),
                                   interpret=True)),
        atol=1e-6,
    )


def test_ssd_scan_checks_and_routes():
    s = torch.zeros((2, 3, 4, 4))
    with pytest.raises(ValueError, match="bad shapes"):
        ssd_scan(s[0], torch.zeros((2, 3)))
    with pytest.raises(ValueError, match="decay"):
        ssd_scan(s, torch.zeros((2, 4)))
    with pytest.raises(ValueError, match="needs CUDA"):
        ssd_scan_cuda(s, torch.zeros((2, 3)))
    before = ssd_scan_cuda.launches
    ssd_scan(s, torch.ones((2, 3)))      # a CPU tensor runs the plain version
    assert ssd_scan_cuda.launches == before


# ---------------------------------------------------------------------------
# the Mamba2 mixer
# ---------------------------------------------------------------------------

# S a multiple of the chunk (32), S not a multiple, S below the chunk
SEQS = [64, 50, 20]


@pytest.mark.parametrize("s", SEQS)
def test_mamba_apply_parity(s):
    r_cfg, t_cfg, params, model = _weights()
    x = np.random.default_rng(s).standard_normal((2, s, r_cfg.d_model)).astype(np.float32)
    p0 = _layer_params(params, 0)
    want = RM.mamba_apply(p0, r_cfg, jnp.asarray(x))
    want2, want_st = RM.mamba_apply(p0, r_cfg, jnp.asarray(x), return_state=True)
    mixer = model.layers[0].mamba
    with torch.no_grad():
        got = M.mamba_apply(mixer, t_cfg, _t(x))
        got2, st = M.mamba_apply(mixer, t_cfg, _t(x), return_state=True)
    assert got.shape == (2, s, r_cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **TOL)
    assert st["ssm"].dtype == torch.float32
    for t in st.values():  # the state holds its own bytes, not a view of a
        assert t.untyped_storage().nbytes() == t.nbytes   # prefill tensor
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(want_st["ssm"]), **TOL)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(want_st["conv"]), **TOL)


def test_mamba_decode_parity():
    """Decode steps from a prefill state, each fed the same input."""
    r_cfg, t_cfg, params, model = _weights()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 41, r_cfg.d_model)).astype(np.float32)
    p0 = _layer_params(params, 1)
    _, r_st = RM.mamba_apply(p0, r_cfg, jnp.asarray(x), return_state=True)
    mixer = model.layers[1].mamba
    with torch.no_grad():
        _, st = M.mamba_apply(mixer, t_cfg, _t(x), return_state=True)
        for step in range(5):
            xt = rng.standard_normal((3, 1, r_cfg.d_model)).astype(np.float32)
            want, r_st = RM.mamba_decode(p0, r_cfg, jnp.asarray(xt), r_st)
            got, st = M.mamba_decode(mixer, t_cfg, _t(xt), st)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(r_st["ssm"]), **TOL)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(r_st["conv"]), **TOL)
    assert st["conv"].untyped_storage().nbytes() == st["conv"].nbytes
    # a zero state decodes like the reference's zero state
    zero = M.mamba_state_init(t_cfg, 3)
    r_zero = RM.mamba_state_init(r_cfg, 3)
    assert zero["ssm"].shape == r_zero["ssm"].shape
    assert zero["conv"].shape == r_zero["conv"].shape


# ---------------------------------------------------------------------------
# the mamba2 LM: forward, prefill, decode
# ---------------------------------------------------------------------------

def test_ssm_forward_parity():
    r_cfg, t_cfg, params, model = _weights()
    toks = _tokens(1, 2, 70)
    want, _ = R.ssm_forward(params, r_cfg, jnp.asarray(toks))
    got, aux = T.ssm_forward(model, t_cfg, _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


def _check_cache(t_cache, r_cache, n_layers):
    assert len(t_cache) == n_layers
    for i, layer in enumerate(t_cache):
        np.testing.assert_allclose(layer["ssm"].numpy(), np.asarray(r_cache["ssm"][i]),
                                   **TOL)
        np.testing.assert_allclose(layer["conv"].numpy(),
                                   np.asarray(r_cache["conv"][i]), **TOL)


@pytest.mark.parametrize("s,lens", [(50, (50, 31)), (20, (20, 20)), (64, (64, 9))])
def test_ssm_prefill_and_decode_parity(s, lens):
    """Ragged prefill (logits and every layer's state), then decode steps
    fed the reference's greedy tokens."""
    r_cfg, t_cfg, params, model = _weights()
    toks = _tokens(2 + s, 2, s)
    lens = np.array(lens, np.int32)
    logits, cache = R.ssm_prefill(params, r_cfg, jnp.asarray(toks), max_len=96,
                                  lengths=jnp.asarray(lens))
    t_logits, t_cache = T.ssm_prefill(model, t_cfg, _t(toks), max_len=96,
                                      lengths=_t(lens).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    _check_cache(t_cache, cache, r_cfg.n_layers)
    pos = lens.copy()
    for _ in range(6):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.ssm_decode_step(params, r_cfg, jnp.asarray(tok),
                                          jnp.asarray(pos), cache)
        t_logits, t_cache = T.ssm_decode_step(model, t_cfg, _t(tok).long(),
                                              _t(pos).long(), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    _check_cache(t_cache, cache, r_cfg.n_layers)


def test_ragged_batch_state_absorbs_the_pads_as_the_reference_does():
    """A short prompt in a ragged batch: its logits equal the prompt's
    served alone, but its state has absorbed the batch's right pads, in the
    reference and in the port alike (ROADMAP Queue 3)."""
    r_cfg, t_cfg, params, model = _weights()
    toks = _tokens(9, 2, 9)
    toks[0, 5:] = 0                      # the engine's pad id
    lens = np.array([5, 9], np.int32)
    _, r_cache = R.ssm_prefill(params, r_cfg, jnp.asarray(toks),
                               lengths=jnp.asarray(lens))
    t_logits, t_cache = T.ssm_prefill(model, t_cfg, _t(toks), lengths=_t(lens).long())
    _check_cache(t_cache, r_cache, r_cfg.n_layers)
    alone_logits, alone = T.ssm_prefill(model, t_cfg, _t(toks[:1, :5]))
    np.testing.assert_allclose(t_logits[:1].numpy(), alone_logits.numpy(), **TOL)
    gap = float((t_cache[0]["ssm"][0] - alone[0]["ssm"][0]).abs().max())
    assert gap > 1e-3                    # the pads moved sequence 0's state


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


def test_serve_launcher_serves_mamba2_on_cpu():
    from repro_torch.launch import serve

    out = serve.run(serve.build_parser().parse_args(
        ["--arch", ARCH, "--device", "cpu", "--max-new-tokens", "3",
         "--repeats", "2"]))
    cfg = get_config(ARCH).smoke()
    assert out["n_layers"] == 4 and out["device"] == "cpu"
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    # batch 2 x 4 layers x (f32 ssm state (H, P, N) + bf16 conv tail (K-1, conv_dim))
    state = cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 4
    conv = (cfg.ssm_conv - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2
    assert out["kv_cache_bytes"] == 2 * 4 * (state + conv)


def test_init_ssm_shapes_dtypes_and_seed():
    cfg = get_config(ARCH).smoke()
    api = build_model(cfg)
    m = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    again = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    mx = m.layers[0].mamba
    assert len(m.layers) == 4 and mx.in_proj.shape == (128, 2 * 256 + 2 * 32 + 8)
    assert mx.in_proj.dtype == torch.bfloat16 and mx.out_proj.dtype == torch.bfloat16
    for n in ("conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm_w"):
        assert getattr(mx, n).dtype == torch.float32, n
    assert torch.equal(again.layers[3].mamba.in_proj, m.layers[3].mamba.in_proj)
    cache = api.cache_init(2, 16, device="cpu")
    assert cache[0]["ssm"].shape == (2, 8, 32, 32) and cache[0]["conv"].dtype == torch.bfloat16
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init(torch.Generator(device="cpu"), "cuda")


def test_parameter_bridge_round_trip():
    r_cfg, t_cfg, params, model = _weights()
    back = params_to_reference(model)
    want = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    assert sorted(back) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(back[n], want[n], err_msg=n)
    bf = _weights("bfloat16")[3].layers[0].mamba
    assert bf.in_proj.dtype == torch.bfloat16 and bf.a_log.dtype == torch.float32


def test_checkpoint_cross_restore(tmp_path):
    """The reference's checkpoint of ``init_ssm`` loads into the port; the
    port's checkpoint of the same model restores in the reference."""
    r_cfg, t_cfg, params, _ = _weights()
    r_save_pytree(params, tmp_path / "ref")
    model = params_from_reference(t_cfg, restore_named(tmp_path / "ref", device="cpu"),
                                  device="cpu")
    save_pytree(params_to_reference(model), tmp_path / "port")
    back = r_restore_pytree(params, tmp_path / "port")
    for (n, a), (_, b) in zip(_flatten_with_names(params), _flatten_with_names(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)
