"""The port's LM path against the reference's, on the CPU.

One set of weights serves both packages: the reference draws them with
``jax.random`` (``init_lm``), they are flattened under the reference's
checkpoint names and loaded into the port by the parameter bridge
(``models/weights.py``).  Inputs are made from seeds with numpy.  The
configs are the reduced ``get_config(...).smoke()`` ones in float32, where
both packages do the same float32 arithmetic in another order, so hidden
states, logits and caches agree within ``atol = rtol = 1e-4``, and greedy
tokens are identical.  The QKV-bias configs (qwen2-72b, qwen1.5-110b) get
seeded nonzero biases in place of the init's zeros (``torch_qkv_bias``),
so that the bias add is held by value.  bfloat16 rounds at other places in the two
frameworks, so the bfloat16 case compares logits at ``BF16_ATOL``.
"""

import dataclasses
import hashlib
import json

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
from repro.data.tokenizer import ByteTokenizer as RTok, render_example as r_render
from repro.models import transformer as R
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.checkpoint.manager import (
    load_catalog,
    read_tensor,
    restore_named,
    restore_pytree,
    save_pytree,
)
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.data.tokenizer import ByteTokenizer, render_example
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference, params_to_reference
from repro_torch.serve.engine import Engine, ServeConfig
from torch_qkv_bias import draw_biases

TOL = dict(atol=1e-4, rtol=1e-4)
BF16_ATOL = 5e-2  # bfloat16 logits of the smoke config (|logit| < ~1)
PARITY_ARCHS = ["yi-6b", "qwen2-72b", "qwen1.5-110b", "gemma3-12b", "internvl2-76b"]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread is fast enough, and the
    test workers beside this one keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfgs(arch, dtype="float32"):
    r_cfg = dataclasses.replace(r_get_config(arch).smoke(), dtype=dtype)
    t_cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    return r_cfg, t_cfg


_WEIGHTS = {}


def _weights(arch, dtype="float32"):
    """(reference cfg, port cfg, reference params, port model), cached;
    nonzero QKV biases where the config has them."""
    if (arch, dtype) not in _WEIGHTS:
        r_cfg, t_cfg = _cfgs(arch, dtype)
        params, _ = R.init_lm(r_cfg, jax.random.PRNGKey(7))
        params = draw_biases(params, r_cfg, 7)
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        model = params_from_reference(t_cfg, named, device="cpu")
        _WEIGHTS[arch, dtype] = (r_cfg, t_cfg, params, model)
    return _WEIGHTS[arch, dtype]


def _tokens(seed, b, s, vocab=259):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _extra(cfg, b, seed=1):
    if not cfg.n_img_tokens:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _port_cache(cache, r_cfg, layer):
    """The reference's cache arrays of one layer (stacked per scan step)."""
    per = len(R.layer_windows(r_cfg))
    c = cache[f"pos{layer % per}"]
    return np.asarray(c["k"][layer // per]), np.asarray(c["v"][layer // per])


# ---------------------------------------------------------------------------
# configs, tokenizer, checkpoints, the parameter bridge
# ---------------------------------------------------------------------------

def test_configs_are_the_references():
    for arch in ARCH_NAMES:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(r_get_config(arch))
        assert (dataclasses.asdict(get_config(arch).smoke())
                == dataclasses.asdict(r_get_config(arch).smoke()))


def test_tokenizer_matches_reference():
    a, b = ByteTokenizer(), RTok()
    for text in ["InChI=1S/C12H22O2/", "", "é\nXLOGP3=1.5"]:
        assert a.encode(text) == b.encode(text)
        assert a.encode(text, add_bos=False, add_eos=False) == b.encode(
            text, add_bos=False, add_eos=False)
        ids = b.encode(text)
        assert a.decode(ids) == b.decode(ids)
        for n in (0, 3, 40):
            for x, y in zip(a.pad_to(ids, n), b.pad_to(ids, n)):
                np.testing.assert_array_equal(x, y)
    record = ("x\n  RDKit\n\n> <PUBCHEM_IUPAC_INCHI>\nInChI=1S/CH4/h1H4\n\n"
              "> <PUBCHEM_XLOGP3>\n1.1\n\n$$$$\n")
    assert render_example(record) == r_render(record) is not None
    assert render_example(record.replace("XLOGP3", "OTHER")) is None


def _ckpt_tree():
    rng = np.random.default_rng(3)
    return {
        "embed": {"table": jnp.asarray(rng.standard_normal((9, 4)), jnp.float32)},
        "blocks": {"attn": {"wq": jnp.asarray(rng.standard_normal((2, 4, 6)),
                                              jnp.bfloat16)},
                   "ln1": jnp.ones((2, 4), jnp.float32)},
        "step": jnp.asarray(rng.integers(0, 2**31, (3,)), jnp.int32),
    }


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _ckpt_tree()
    r_save_pytree(tree, tmp_path / "ck")
    got = restore_named(tmp_path / "ck", device="cpu")
    want = dict(_flatten_with_names(tree))
    assert list(got) == list(want)  # the reference's order and names
    for name, arr in want.items():
        t = got[name]
        if name == "blocks/attn/wq":
            assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(arr, dtype=np.float32))
    nested = restore_pytree({"blocks": {"attn": {"wq": 0}}}, tmp_path / "ck",
                            device="cpu")
    assert torch.equal(nested["blocks"]["attn"]["wq"], got["blocks/attn/wq"])


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _ckpt_tree()
    r_save_pytree(tree, tmp_path / "ref")
    port_tree = restore_pytree(tree, tmp_path / "ref", device="cpu")
    save_pytree(port_tree, tmp_path / "port", meta={"step": 3})
    # byte for byte the reference's files
    for f in ("shard_00000.bin", "catalog.csv"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    back = r_restore_pytree(tree, tmp_path / "port")
    for (n, a), (_, b) in zip(_flatten_with_names(tree), _flatten_with_names(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, n
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == {"step": 3}


def test_checkpoint_digest_is_checked(tmp_path):
    save_pytree({"a": torch.arange(6, dtype=torch.float32),
                 "b": torch.ones(4, dtype=torch.bfloat16)}, tmp_path / "ck")
    cat = load_catalog(tmp_path / "ck")
    want = hashlib.blake2b(torch.arange(6, dtype=torch.float32).numpy().tobytes(),
                           digest_size=16).hexdigest()
    assert cat["a"].digest == want and cat["b"].dtype == "bfloat16"
    shard = tmp_path / "ck" / "shard_00000.bin"
    raw = bytearray(shard.read_bytes())
    raw[cat["b"].byte_offset] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert torch.equal(read_tensor(tmp_path / "ck", cat["a"]), torch.arange(6.0))
    with pytest.raises(IOError, match="integrity"):
        read_tensor(tmp_path / "ck", cat["b"])
    with pytest.raises(IOError, match="integrity"):
        restore_named(tmp_path / "ck", device="cpu")


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_parameter_bridge_round_trip(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    back = params_to_reference(model)
    want = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
    assert sorted(back) == sorted(want)
    for n in want:
        np.testing.assert_array_equal(back[n], want[n], err_msg=n)
    assert model.layers[0].attn.wq.dtype == torch.float32
    assert len(model.layers) == r_cfg.n_layers


# ---------------------------------------------------------------------------
# lm_forward, lm_prefill, lm_decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_lm_forward_parity(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    toks, extra = _tokens(1, 2, 40), _extra(r_cfg, 2)
    want, _ = R.lm_forward(params, r_cfg, jnp.asarray(toks),
                           None if extra is None else jnp.asarray(extra))
    with torch.no_grad():
        got, aux = T.lm_forward(model, t_cfg, _t(toks), _t(extra))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", PARITY_ARCHS)
def test_lm_prefill_and_decode_parity(arch):
    """Ragged prefill (logits and every layer's cache), then decode steps
    fed the reference's greedy tokens; on gemma3 the decode runs past the
    smoke window of 64, through the ring buffer."""
    r_cfg, t_cfg, params, model = _weights(arch)
    b, s, max_len = 2, 50, 120
    toks, extra = _tokens(2, b, s), _extra(r_cfg, b)
    lens = np.array([s, 31], np.int32)
    logits, cache = R.lm_prefill(params, r_cfg, jnp.asarray(toks),
                                 None if extra is None else jnp.asarray(extra),
                                 max_len=max_len, lengths=jnp.asarray(lens))
    t_logits, t_cache = T.lm_prefill(model, t_cfg, _t(toks), _t(extra),
                                     max_len=max_len, lengths=_t(lens).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    for layer in range(r_cfg.n_layers):
        k, v = _port_cache(cache, r_cfg, layer)
        np.testing.assert_allclose(t_cache[layer]["k"].numpy(), k, **TOL)
        np.testing.assert_allclose(t_cache[layer]["v"].numpy(), v, **TOL)

    off = r_cfg.n_img_tokens or 0
    pos = lens + off
    steps = 30 if r_cfg.window else 6
    for _ in range(steps):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.lm_decode_step(params, r_cfg, jnp.asarray(tok),
                                         jnp.asarray(pos), cache)
        t_logits, t_cache = T.lm_decode_step(model, t_cfg, _t(tok).long(),
                                             _t(pos).long(), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    if r_cfg.window:
        assert pos.max() > r_cfg.window  # the ring buffer wrapped
    for layer in range(r_cfg.n_layers):
        k, v = _port_cache(cache, r_cfg, layer)
        np.testing.assert_allclose(t_cache[layer]["k"].numpy(), k, **TOL)
        np.testing.assert_allclose(t_cache[layer]["v"].numpy(), v, **TOL)


def test_prefill_launches_the_wrapper_only_on_cuda():
    """On the CPU the plain version runs: no kernel launch is counted."""
    _, t_cfg, _, model = _weights("yi-6b")
    before = flash_attention_cuda.launches
    T.lm_prefill(model, t_cfg, _t(_tokens(3, 1, 9)))
    assert flash_attention_cuda.launches == before


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)",
           "C", "InChI=1S/H2O/h1H2"]


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-12b"])
def test_engine_greedy_tokens_identical_to_reference(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    prompts = PROMPTS + (["y" * 70] if r_cfg.window else [])  # longer than the window
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=12, max_len=96,
                                               sync_every=4)).generate(prompts)
    got = Engine(t_cfg, model, ServeConfig(max_new_tokens=12, max_len=96,
                                           sync_every=4), device="cpu").generate(prompts)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.prompt_len for r in got] == [r.prompt_len for r in want]
    assert [r.text for r in got] == [r.text for r in want]
    assert got[0].steps == want[0].steps


def test_engine_sampling_is_seeded():
    _, t_cfg, _, model = _weights("yi-6b")
    scfg = ServeConfig(max_new_tokens=6, max_len=64, greedy=False, seed=5)
    eng = Engine(t_cfg, model, scfg, device="cpu")
    a = eng.generate(PROMPTS[:2])
    b = eng.generate(PROMPTS[:2])
    assert [r.token_ids for r in a] == [r.token_ids for r in b]
    assert all(len(r.token_ids) <= 6 for r in a)


def test_bf16_prefill_logits_near_reference():
    r_cfg, t_cfg, params, model = _weights("yi-6b", "bfloat16")
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    toks = _tokens(4, 2, 33)
    lens = np.array([33, 20], np.int32)
    want, _ = R.lm_prefill(params, r_cfg, jnp.asarray(toks), max_len=64,
                           lengths=jnp.asarray(lens))
    got, cache = T.lm_prefill(model, t_cfg, _t(toks), max_len=64,
                              lengths=_t(lens).long())
    assert got.dtype == torch.bfloat16 and cache[0]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), atol=BF16_ATOL)
    tok = torch.argmax(got, -1)[:, None]
    step, _ = T.lm_decode_step(model, t_cfg, tok, _t(lens).long(), cache)
    assert torch.isfinite(step.float()).all()


# ---------------------------------------------------------------------------
# API surface
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_every_config_builds_and_prefills_on_the_cpu(arch):
    """Every family of the reference is ported: each config's smoke model
    builds on the CPU and prefills a ragged batch to finite logits, feeding
    what its loss reads (patch embeddings, audio frames)."""
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    api = build_model(cfg)
    model = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    batch = {"tokens": _t(_tokens(9, 2, 7)).long(), "lengths": torch.tensor([7, 3])}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _t(_extra(cfg, 2))
    if cfg.family == "encdec":
        batch["frames"] = torch.zeros((2, cfg.enc_frames, cfg.d_model))
    logits, _ = api.prefill(model, batch, max_len=16)
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()


def test_init_lm_and_engine_device_checks():
    cfg = dataclasses.replace(get_config("yi-6b").smoke(), n_layers=1)
    g = torch.Generator(device="cpu").manual_seed(0)
    model = build_model(cfg).init(g, "cpu")
    assert len(model.layers) == 1 and model.embed.table.shape == (512, 128)
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    assert model.layers[0].ln1.weight.dtype == torch.float32
    g2 = torch.Generator(device="cpu").manual_seed(0)
    again = build_model(cfg).init(g2, "cpu")
    assert torch.equal(again.layers[0].mlp.wd, model.layers[0].mlp.wd)
    with pytest.raises(ValueError, match="engine on"):
        Engine(cfg, again.to("meta"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(cfg).init(g, "cuda")


def test_serve_launcher_runs_on_cpu_and_continuous_gives_static_tokens(capsys):
    from repro_torch.launch import serve

    out = serve.run(serve.build_parser().parse_args(
        ["--device", "cpu", "--max-new-tokens", "3", "--max-len", "32",
         "--repeats", "2"]))
    assert out["device"] == "cpu" and out["n_layers"] == 4
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    # batch 2 x 4 layers x (k, v) x 1 KV head x 32 slots x 32 dims x 2 bytes
    assert out["kv_cache_bytes"] == 2 * 4 * 2 * 1 * 32 * 32 * 2
    cont = serve.run(serve.build_parser().parse_args(
        ["--continuous", "--device", "cpu", "--max-new-tokens", "3",
         "--max-len", "32"]))
    assert cont["continuous"] and cont["runs"][0]["token_ids"] == out["runs"][0]["token_ids"]
    # 2 slots of blocks_for(32, 16) = 2 blocks, 2 of prefix headroom, 2 more
    assert cont["spec"]["n_blocks"] == 8 * 2 + 2 + 2
    assert cont["counters"]["completed"] == 2
    assert "slo: ttft p50" in capsys.readouterr().out


def test_serve_launcher_serves_a_callers_config():
    """``serve.run(args, cfg)`` serves the caller's cut of a config (the
    launcher has no depth option): the cut's depth, weights and cache, the
    tokens of an ``Engine`` on the same seed's weights."""
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args(
        ["--device", "cpu", "--max-new-tokens", "3", "--max-len", "32", "--seed", "5"])
    cfg = dataclasses.replace(get_config("yi-6b").smoke(), n_layers=1)
    out = serve.run(args, cfg)
    assert out["n_layers"] == 1 and out["engine"].cfg is cfg
    # batch 2 x 1 layer x (k, v) x 1 KV head x 32 slots x 32 dims x 2 bytes
    assert out["kv_cache_bytes"] == 2 * 1 * 2 * 1 * 32 * 32 * 2
    model = build_model(cfg).init(torch.Generator(device="cpu").manual_seed(5), "cpu")
    assert out["weight_bytes"] == sum(p.numel() * p.element_size()
                                      for p in model.parameters())
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=3, max_len=32), device="cpu")
    assert out["runs"][0]["token_ids"] == [r.token_ids for r in eng.generate(args.prompts)]
