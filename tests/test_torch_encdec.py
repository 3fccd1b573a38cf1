"""The port's encoder-decoder family (whisper-small) against the reference's,
on the CPU.

One set of weights serves both packages: the reference draws them with
``jax.random`` (``init_encdec``), they are flattened under the reference's
checkpoint names and loaded into the port by the parameter bridge
(``models/weights.py``).  Frames and tokens are made from seeds with numpy.
On the f32 smoke config both packages do the same float32 arithmetic in
another order, so encoder outputs, hidden states, logits and both caches
agree within ``atol = rtol = 1e-4``, greedy tokens are identical, and the
loss and its gradients agree with ``jax.grad`` within 1e-4 relative (the
reference runs as its own tests run it on the CPU: ``flash_attention``
through its XLA path).
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
from repro.models import encdec as R
from repro.models.registry import build_model as r_build_model
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.checkpoint.manager import restore_named, save_pytree
from repro_torch.configs import get_config
from repro_torch.models import encdec as E
from repro_torch.models.registry import build_model
from repro_torch.models.weights import (
    named_to_reference,
    params_from_reference,
    params_to_reference,
    state_to_reference,
)
from repro_torch.serve.engine import Engine, ServeConfig

ARCH = "whisper-small"
TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 5e-2  # bfloat16 logits of the smoke config (|logit| < ~1)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """Small tensors: one intra-op thread, and the other test workers keep
    their cores."""
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
        params, _ = R.init_encdec(r_cfg, jax.random.PRNGKey(11))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[dtype] = (r_cfg, t_cfg, params,
                           params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[dtype]


def _frames(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32)


def _tokens(seed, b, s, vocab=259):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_parameter_bridge_round_trip():
    r_cfg, t_cfg, params, model = _weights()
    back = params_to_reference(model)
    want = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    assert sorted(back) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(back[n], want[n], err_msg=n)
    assert len(model.enc_blocks) == r_cfg.n_enc_layers
    assert len(model.dec_blocks) == r_cfg.n_layers
    assert model.enc_pos.shape == (r_cfg.enc_frames, r_cfg.d_model)


def test_bf16_bridge_casts_matrices_keeps_norms_float32():
    _, _, _, model = _weights("bfloat16")
    assert model.enc_pos.dtype == torch.bfloat16
    assert model.dec_blocks[0].cross.wk.dtype == torch.bfloat16
    assert model.embed.unembed.dtype == torch.bfloat16
    assert model.enc_norm.weight.dtype == torch.float32
    assert model.dec_blocks[0].ln3.weight.dtype == torch.float32


def test_encode_and_forward_parity():
    r_cfg, t_cfg, params, model = _weights()
    frames, toks = _frames(r_cfg, 2), _tokens(1, 2, 40)
    want_enc = R.encode(params, r_cfg, jnp.asarray(frames))
    want = R.encdec_forward(params, r_cfg, jnp.asarray(frames), jnp.asarray(toks))
    with torch.no_grad():
        got_enc = E.encode(model, t_cfg, _t(frames))
        got = E.encdec_forward(model, t_cfg, _t(frames), _t(toks))
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _check_cache(t_cache, cache):
    for part in ("self", "cross"):
        for name in ("k", "v"):
            np.testing.assert_allclose(t_cache[part][name].numpy(),
                                       np.asarray(cache[part][name]),
                                       err_msg=f"{part}/{name}", **TOL)


def test_prefill_and_decode_parity():
    """Ragged prefill (logits, the self and cross caches), then 3 decode
    steps fed the reference's greedy tokens; the self cache after them."""
    r_cfg, t_cfg, params, model = _weights()
    b, s, max_len = 2, 30, 48
    frames, toks = _frames(r_cfg, b, seed=2), _tokens(2, b, s)
    lens = np.array([s, 17], np.int32)
    logits, cache = R.encdec_prefill(params, r_cfg, jnp.asarray(frames),
                                     jnp.asarray(toks), max_len=max_len,
                                     lengths=jnp.asarray(lens))
    t_logits, t_cache = E.encdec_prefill(model, t_cfg, _t(frames), _t(toks),
                                         max_len=max_len, lengths=_t(lens).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    assert t_cache["self"]["k"].shape == (r_cfg.n_layers, b, r_cfg.n_kv_heads,
                                          max_len, r_cfg.resolved_head_dim)
    assert t_cache["cross"]["v"].shape[3] == r_cfg.enc_frames
    _check_cache(t_cache, cache)
    pos = lens.copy()
    for _ in range(3):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.encdec_decode_step(params, r_cfg, jnp.asarray(tok),
                                             jnp.asarray(pos), cache)
        t_logits, t_cache = E.encdec_decode_step(model, t_cfg, _t(tok).long(),
                                                 _t(pos).long(), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    _check_cache(t_cache, cache)


def test_cache_init_layout():
    _, t_cfg, _, _ = _weights()
    cache = build_model(t_cfg).cache_init(3, 20, device="cpu")
    l, hkv, dh = t_cfg.n_layers, t_cfg.n_kv_heads, t_cfg.resolved_head_dim
    assert cache["self"]["k"].shape == (l, 3, hkv, 20, dh)
    assert cache["cross"]["k"].shape == (l, 3, hkv, t_cfg.enc_frames, dh)
    assert all(float(t.abs().sum()) == 0 for part in cache.values()
               for t in part.values())


def test_prefill_calls_flash_attention_three_times_a_layer_pair(monkeypatch):
    """One non-causal call per encoder layer over the frames; per decoder
    layer one causal over the prompt and one non-causal of the prompt's
    rows against the frames (``Skv`` = frames): the launches a prefill
    makes on the card."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models import common

    _, t_cfg, _, model = _weights()
    calls = []

    def counted(q, k, v, causal=True, window=None, scale=None):
        calls.append((q.shape[2], k.shape[2], causal, window))
        return flash_attention(q, k, v, causal, window, scale)

    # every call, the encoder's, the decoder's and the prefill's, goes
    # through common.attend
    monkeypatch.setattr(common, "flash_attention", counted)
    f, s = t_cfg.enc_frames, 9
    E.encdec_prefill(model, t_cfg, torch.zeros((1, f, t_cfg.d_model)),
                     _t(_tokens(5, 1, s)))
    enc = [(f, f, False, None)] * t_cfg.n_enc_layers
    dec = [(s, s, True, None), (s, f, False, None)] * t_cfg.n_layers
    assert calls == enc + dec


def test_bf16_prefill_logits_near_reference():
    r_cfg, t_cfg, params, model = _weights("bfloat16")
    frames, toks = _frames(r_cfg, 2, seed=4), _tokens(4, 2, 21)
    lens = np.array([21, 9], np.int32)
    want, _ = R.encdec_prefill(params, r_cfg, jnp.asarray(frames), jnp.asarray(toks),
                               max_len=32, lengths=jnp.asarray(lens))
    got, cache = E.encdec_prefill(model, t_cfg, _t(frames), _t(toks), max_len=32,
                                  lengths=_t(lens).long())
    assert got.dtype == torch.bfloat16 and cache["cross"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=BF16_ATOL)


PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)", "C"]


def test_engine_greedy_tokens_identical_to_reference():
    """Both engines feed zero frames (the stub frontend)."""
    r_cfg, t_cfg, params, model = _weights()
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=10, max_len=80,
                                               sync_every=4)).generate(PROMPTS)
    eng = Engine(t_cfg, model, ServeConfig(max_new_tokens=10, max_len=80,
                                           sync_every=4), device="cpu")
    got = eng.generate(PROMPTS)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert got[0].steps == want[0].steps
    l, b, hkv, dh = t_cfg.n_layers, len(PROMPTS), t_cfg.n_kv_heads, t_cfg.resolved_head_dim
    assert eng.kv_cache_bytes == 2 * l * b * hkv * (80 + t_cfg.enc_frames) * dh * 4


def _loss_batch(cfg, seed, b=2, s=40):
    rng = np.random.default_rng(seed)
    return {"frames": _frames(cfg, b, seed),
            "tokens": rng.integers(0, 259, (b, s)).astype(np.int32),
            "loss_mask": (rng.random((b, s)) < 0.8).astype(np.float32)}


def test_loss_and_grads_match_reference():
    r_cfg, t_cfg, params, _ = _weights()
    rapi, api = r_build_model(r_cfg), build_model(t_cfg)
    named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    model = params_from_reference(t_cfg, named, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    batch = _loss_batch(r_cfg, 3)
    (r_loss, r_metrics), r_grads = jax.value_and_grad(rapi.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = api.loss(model, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss.detach()), float(r_loss), rtol=1e-4)
    assert float(metrics["aux"]) == float(r_metrics["aux"]) == 0.0
    params_t = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params_t.values()))
    got = named_to_reference(model, dict(zip(params_t, grads)))
    want = {n: np.asarray(a) for n, a in _flatten_with_names(r_grads)}
    assert set(got) == set(want)
    for n, w in want.items():
        g = got[n].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, n
        assert (np.abs(w).max() == 0) == (np.abs(g).max() == 0), n


def test_train_state_names_are_the_references():
    from repro_torch.train.loop import make_train_state

    _, t_cfg, params, _ = _weights()
    state = make_train_state(build_model(t_cfg), torch.Generator().manual_seed(0),
                             device="cpu")
    names = {n for n, _ in _flatten_with_names(params)}
    ref = state_to_reference(state)
    for prefix in ("params", "opt/m", "opt/v"):
        assert {n[len(prefix) + 1:] for n in ref if n.startswith(prefix + "/")
                and n.count("/") > prefix.count("/")} >= names
    assert ref["params/enc_pos"].shape == (t_cfg.enc_frames, t_cfg.d_model)
    assert ref["params/dec_blocks/cross/wq"].dtype == torch.float32


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """Whisper's parameters written by one package open in the other and
    give the same model."""
    r_cfg, t_cfg, params, model = _weights()
    if writer == "port":
        save_pytree(params_to_reference(model), tmp_path / "ck")
        back = r_restore_pytree(params, tmp_path / "ck")
        for (n, a), (_, b) in zip(_flatten_with_names(params),
                                  _flatten_with_names(back)):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=n)
    else:
        r_save_pytree(params, tmp_path / "ck")
        restored = params_from_reference(
            t_cfg, restore_named(tmp_path / "ck", device="cpu"), device="cpu")
        for (n, a), b in zip(model.state_dict().items(), restored.state_dict().values()):
            assert torch.equal(a, b), n


def test_launchers_serve_statically_and_refuse_what_the_family_lacks(tmp_path, capsys):
    from repro_torch.launch import serve, train

    args = ["--arch", ARCH, "--device", "cpu", "--max-new-tokens", "4",
            "--max-len", "48", "--repeats", "2", "--prompts", "InChI=1S/C4", "C"]
    out = serve.run(serve.build_parser().parse_args(args))
    assert "audio frontend stubbed" in capsys.readouterr().out
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    assert all(1 <= len(t) <= 4 for t in out["runs"][0]["token_ids"])
    with pytest.raises(SystemExit, match="no paged-KV decode path"):
        serve.run(serve.build_parser().parse_args(args + ["--continuous"]))
    with pytest.raises(NotImplementedError, match="frames"):
        train.run(train.build_parser().parse_args(
            ["--arch", ARCH, "--device", "cpu", "--steps", "1",
             "--workdir", str(tmp_path / "run")]))
    assert not (tmp_path / "run").exists()  # refused before the corpus
