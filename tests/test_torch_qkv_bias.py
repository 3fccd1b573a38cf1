"""The QKV-bias family, qwen2-72b and qwen1.5-110b, with nonzero biases:
what the parametrised parity tests do not cover.

Both packages initialise ``bq``, ``bk`` and ``bv`` to zeros.  The parity
tests of ``test_torch_models.py`` (bridge, forward, ragged prefill with
every cache, decode) and ``test_torch_train.py`` (loss and every gradient)
draw seeded nonzero biases into the reference's params for these configs
(``torch_qkv_bias``); so does this file, for the paths that those tests do
not take: the serve launcher's own draw, the paged decode step and suffix
prefill, the static engine's step as the CUDA graph captures it
(``decode="static"``) and the continuous engine with prefix sharing on.
The configs are the reduced ``smoke()`` ones in float32.  Controls:
zeroing one layer's ``bq`` or ``bv`` on the port's side must fail the
logits comparison, and zeroing its ``bk`` must fail the K cache comparison
(before RoPE a key bias adds ``q . bk`` to every score of a row, and only
its position-dependent part survives the softmax, so a lost ``bk`` shows in
the K cache first).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.models import transformer as R
from repro.models.registry import build_model as r_build_model
from repro.serve import kvcache as RK
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.common import draw_qkv_biases
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import ContinuousEngine
from torch_qkv_bias import BIASES, draw_biases

ARCHS = ["qwen2-72b", "qwen1.5-110b"]
TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, BS = 96, 8
STEM = "InChI=1S/C8H9NO2/c1-6(10)9-7-2-4-8(11)5-3-7;"  # 46 tokens with BOS
SHARED = [STEM + tail for tail in ("a1", "b22", "c333", "a1")]
PROMPT = [256] + list(b"InChI=1S/C8H9NO2/c1-6(")   # 24 tokens: 3 blocks


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfgs(arch):
    return (dataclasses.replace(r_get_config(arch).smoke(), dtype="float32"),
            dataclasses.replace(get_config(arch).smoke(), dtype="float32"))


_WEIGHTS = {}


def _weights(arch):
    """(reference cfg, port cfg, reference params with nonzero biases, port
    model loaded from them), cached."""
    if arch not in _WEIGHTS:
        r_cfg, t_cfg = _cfgs(arch)
        seed = 17 + ARCHS.index(arch)
        params, _ = r_build_model(r_cfg).init(jax.random.PRNGKey(seed))
        params = draw_biases(params, r_cfg, seed)
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[arch] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[arch]


def _tokens(seed, b, s):
    return np.random.default_rng(seed).integers(3, 259, (b, s)).astype(np.int32)


def _ref_cache(cache, layer):
    c = cache["pos0"]
    return np.asarray(c["k"][layer]), np.asarray(c["v"][layer])


def _ragged_prefill(arch, model=None):
    """The reference's and the port's ragged prefill of one batch (rows of
    50 and 31 tokens): ``(reference logits, cache, port logits, cache)``."""
    r_cfg, t_cfg, params, base = _weights(arch)
    toks, lens = _tokens(2, 2, 50), np.array([50, 31], np.int32)
    logits, cache = R.lm_prefill(params, r_cfg, jnp.asarray(toks), None,
                                 max_len=MAX_LEN, lengths=jnp.asarray(lens))
    with torch.no_grad():
        t_logits, t_cache = T.lm_prefill(base if model is None else model, t_cfg,
                                         torch.from_numpy(toks).long(), None,
                                         max_len=MAX_LEN,
                                         lengths=torch.from_numpy(lens).long())
    return logits, cache, t_logits, t_cache


# ---------------------------------------------------------------------------
# the launcher's draw
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_draws_nonzero_biases_over_the_inits_zeros(arch):
    """The init keeps the reference's zero biases; the serve launcher fills
    every layer's from its seeded generator after the init (two runs draw
    the same, and serve the same tokens), and ``draw_qkv_biases`` counts
    the attention modules it filled (none on a config without biases)."""
    _, t_cfg = _cfgs(arch)
    fresh = T.init_lm(t_cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(not getattr(layer.attn, n).any() for layer in fresh.layers for n in BIASES)
    argv = ["--arch", arch, "--device", "cpu", "--max-new-tokens", "3",
            "--prompts", "InChI=1S/CH4"]
    a, b = (serve.run(serve.build_parser().parse_args(argv)) for _ in range(2))
    assert a["runs"][0]["token_ids"] == b["runs"][0]["token_ids"]
    for la, lb in zip(a["engine"].model.layers, b["engine"].model.layers):
        for n in BIASES:
            x, y = getattr(la.attn, n), getattr(lb.attn, n)
            assert torch.equal(x, y) and bool(x.any()), n
    assert draw_qkv_biases(fresh, torch.Generator().manual_seed(0)) == t_cfg.n_layers
    assert all(getattr(layer.attn, n).any() for layer in fresh.layers for n in BIASES)
    _, plain_cfg = _cfgs("yi-6b")
    plain = T.init_lm(plain_cfg, torch.Generator().manual_seed(0), "cpu")
    assert draw_qkv_biases(plain, torch.Generator().manual_seed(0)) == 0


# ---------------------------------------------------------------------------
# the paged path and the engines
# ---------------------------------------------------------------------------

def _spec(mod=TK, **kw):
    base = dict(n_blocks=49, block_size=BS, max_slots=3,
                max_blocks_per_seq=MAX_LEN // BS)
    base.update(kw)
    return mod.PagedCacheSpec(**base)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_decode_and_suffix_prefill_parity(arch):
    """A prompt's prefill written to the block pool, its suffix prefilled
    from two block-aligned starts against the reference's suffix prefill,
    then paged decode steps against the reference's, and the pool after."""
    r_cfg, cfg, params, model = _weights(arch)
    r_api, api = r_build_model(r_cfg), build_model(cfg)
    spec, r_spec = _spec(), _spec(RK)
    mgr, r_mgr = TK.BlockManager(spec), RK.BlockManager(r_spec)
    n = len(PROMPT)
    toks = np.full((1, 24), 258, np.int64)
    toks[0, :n] = PROMPT
    pool = api.paged_cache_init(spec.n_blocks, BS, "cpu")
    r_pool, _ = r_api.paged_cache_init(r_spec.n_blocks, BS)
    with torch.no_grad():
        full, dense = api.prefill(model, {"tokens": torch.from_numpy(toks),
                                          "lengths": torch.tensor([n])}, max_len=MAX_LEN)
    r_full, r_dense = r_api.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                             "lengths": jnp.asarray([n])}, max_len=MAX_LEN)
    np.testing.assert_allclose(full.numpy(), np.asarray(r_full), **TOL)
    assert mgr.admit(0, n + 8) and r_mgr.admit(0, n + 8)
    api.paged_prefill_write(pool, dense, torch.from_numpy(mgr.tables[0]), BS)
    r_pool = r_api.paged_prefill_write(r_pool, r_dense, jnp.asarray(r_mgr.tables[0]), BS)
    for start in (8, 16):
        row = mgr.tables[0].copy()
        row[start // BS:3] = [40, 41][: 3 - start // BS]
        with torch.no_grad():
            got, pool = api.prefill_suffix(model, torch.from_numpy(toks[:, start:]), start,
                                           torch.from_numpy(row), pool, BS,
                                           lengths=torch.tensor([n - start]))
        want, r_pool = r_api.prefill_suffix(
            params, jnp.asarray(toks[:, start:], jnp.int32), start, jnp.asarray(row),
            r_pool, BS, lengths=jnp.asarray([n - start]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), full.numpy(), **TOL)
    cur = np.zeros((3, 1), np.int64)
    pos = np.zeros(3, np.int64)
    cur[0, 0], pos[0] = int(np.argmax(np.asarray(r_full)[0])), n
    for _ in range(5):
        with torch.no_grad():
            lg, pool = api.decode_step_paged(model, torch.from_numpy(cur),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(mgr.tables), pool, BS)
        r_lg, r_pool = r_api.decode_step_paged(
            params, jnp.asarray(cur, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(r_mgr.tables), r_pool, BS)
        np.testing.assert_allclose(lg[:1].numpy(), np.asarray(r_lg)[:1], **TOL)
        cur[0, 0] = int(np.argmax(np.asarray(r_lg)[0]))
        pos[0] += 1
    for layer in range(cfg.n_layers):
        for name in "kv":
            np.testing.assert_allclose(pool[layer][name].numpy(),
                                       np.asarray(r_pool["pos0"][name][layer]),
                                       **TOL, err_msg=f"layer {layer} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_with_prefix_sharing_equal_static_and_reference(arch):
    """Greedy tokens of the reference's static engine, the port's static
    engine (eager, and the captured step's code run op by op:
    ``decode="static"``) and the port's ``ContinuousEngine`` with prefix
    sharing on (its eager and static steps), on prompts that share a
    block-aligned prefix: the later ones prefill only their suffix."""
    r_cfg, cfg, params, model = _weights(arch)
    scfg = ServeConfig(max_new_tokens=10, max_len=MAX_LEN)
    want = [r.token_ids for r in REngine(r_cfg, params, RServeConfig(
        max_new_tokens=10, max_len=MAX_LEN)).generate(SHARED)]
    for decode in ("eager", "static"):
        got = Engine(cfg, model, scfg, device="cpu", decode=decode).generate(SHARED)
        assert [r.token_ids for r in got] == want, decode
    for decode in ("eager", "static"):
        eng = ContinuousEngine(cfg, model, _spec(), scfg, prefix_cache=True,
                               device="cpu", decode=decode)
        try:
            got = [r.token_ids for r in eng.generate(SHARED)]
            assert got == want, decode
            assert eng.stats.prefix_hits >= len(SHARED) - 1
            assert eng.stats.prefill_tokens_saved >= 40 * (len(SHARED) - 1)
            eng.check()
        finally:
            eng.close()


# ---------------------------------------------------------------------------
# controls: a lost bias must fail the comparison that should see it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name,where", [("bq", "logits"), ("bv", "logits"),
                                        ("bk", "k cache")])
def test_a_zeroed_bias_fails_the_comparison(arch, name, where):
    """The ragged prefill's comparison (as ``test_torch_models.py``'s
    ``test_lm_prefill_and_decode_parity`` makes it) passes with the biases
    intact, and with layer 0's ``name`` zeroed on the port's side only it
    fails, far outside its tolerance."""
    def compared(model):
        logits, cache, t_logits, t_cache = _ragged_prefill(arch, model)
        if where == "logits":
            return t_logits.numpy(), np.asarray(logits)
        return t_cache[0]["k"].numpy(), _ref_cache(cache, 0)[0]

    np.testing.assert_allclose(*compared(None), **TOL)
    model = copy.deepcopy(_weights(arch)[3])
    with torch.no_grad():
        getattr(model.layers[0].attn, name).zero_()
    got, want = compared(model)
    assert not np.allclose(got, want, **TOL)
    excess = np.abs(got - want) / (TOL["atol"] + TOL["rtol"] * np.abs(want))
    assert excess.max() > 100, f"{where} moved only {excess.max():.3g}x the tolerance"
