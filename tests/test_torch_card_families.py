"""gemma3-12b and internvl2-76b at their published window and image-token
count, the port against the reference on the CPU.

The smoke configs shrink gemma3's window to 64 and internvl2's image
tokens to 16 (``ModelConfig.smoke``).  Here the widths stay narrow (the
smoke ones, in float32) but those two numbers are the published ones, as
the card runs them: gemma3 with a window of 1,024 over 2 layers
(``local_block=2``: one window layer, one global layer), a ragged
prefill whose long row passes the window, so that the sliding mask and
the prefill's ring layout (slot = pos % window) run, then decode steps
past it; internvl2 with 256 image positions of nonzero patch embeddings
before the text.  One set of weights serves both packages (the
reference's ``init_lm`` through ``models/weights.py``); tokens and patch
embeddings are made from seeds with numpy.  Both do float32 arithmetic in
another order, so logits and caches agree within ``atol = rtol = 1e-4``
and greedy tokens are identical.

The same holds at the published ratios of the two families that the card
serves cut in depth: jamba-1.5-large-398b's super-block cut to its
layers 0-3 (``hybrid_block`` 4, attention at 3) and to its layers 2-3
(``hybrid_block`` 2, attention at 1), ``moe_every`` 2, with a prompt over
two SSD chunks; qwen3-moe-235b-a22b with a query width twice d_model
(16 heads of 16 over d_model 128), 16 query heads to its one KV head and
128 experts, top 8.  And internvl2's ``ContinuousEngine`` with its 256
image positions in paged blocks of 24 rows (the image positions end
inside a block) gives the static engine's and the reference continuous
engine's tokens.
"""

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
from repro.serve.scheduler import ContinuousEngine as RContinuousEngine
from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import ContinuousEngine

TOL = dict(atol=1e-4, rtol=1e-4)
WINDOW = 1024       # gemma3-12b's published sliding window
IMG_TOKENS = 256    # internvl2-76b's published image positions
# gemma3's ragged prefill: a row past the window and one inside it
GEMMA_LENS = (1100, 700)
GEMMA_MAX_LEN = 1160
VLM_LENS = (40, 17)
VLM_MAX_LEN = IMG_TOKENS + 64
DECODE_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_intra_op_threads():
    """Narrow widths: two intra-op threads, so the workers beside this one
    keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _cfg(get, arch):
    cfg = dataclasses.replace(get(arch).smoke(), dtype="float32", n_layers=2)
    if arch == "gemma3-12b":
        return dataclasses.replace(cfg, window=WINDOW, local_block=2)
    return dataclasses.replace(cfg, n_img_tokens=IMG_TOKENS)


_WEIGHTS = {}


def _weights(arch):
    """(reference cfg, port cfg, reference params, port model), cached."""
    if arch not in _WEIGHTS:
        r_cfg, t_cfg = _cfg(r_get_config, arch), _cfg(get_config, arch)
        params, _ = R.init_lm(r_cfg, jax.random.PRNGKey(11))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[arch] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[arch]


def _batch(lens, seed):
    """Right-padded random byte tokens of ``lens`` and their lengths."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((len(lens), max(lens)), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(3, 259, n)
    return toks, np.asarray(lens, np.int32)


def _patch_embeds(cfg, b, seed):
    """Seeded nonzero patch embeddings: zeros (the served stub's) would
    hide a wrong image offset."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)


def _ref_cache(cache, r_cfg, layer):
    per = len(R.layer_windows(r_cfg))
    c = cache[f"pos{layer % per}"]
    return np.asarray(c["k"][layer // per]), np.asarray(c["v"][layer // per])


def _check_caches(t_cache, cache, r_cfg):
    for layer in range(r_cfg.n_layers):
        k, v = _ref_cache(cache, r_cfg, layer)
        assert t_cache[layer]["k"].shape == k.shape
        np.testing.assert_allclose(t_cache[layer]["k"].numpy(), k, **TOL)
        np.testing.assert_allclose(t_cache[layer]["v"].numpy(), v, **TOL)


def _prefill_and_decode(arch, toks, lens, extra, max_len):
    """Prefill both packages (logits, every layer's cache), then
    ``DECODE_STEPS`` decode steps fed the reference's greedy tokens.
    Returns the last positions decoded and the port's cache."""
    r_cfg, t_cfg, params, model = _weights(arch)
    logits, cache = R.lm_prefill(params, r_cfg, jnp.asarray(toks),
                                 None if extra is None else jnp.asarray(extra),
                                 max_len=max_len, lengths=jnp.asarray(lens))
    t_logits, t_cache = T.lm_prefill(
        model, t_cfg, torch.from_numpy(toks).long(),
        None if extra is None else torch.from_numpy(extra),
        max_len=max_len, lengths=torch.from_numpy(lens).long())
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    _check_caches(t_cache, cache, r_cfg)
    pos = lens.astype(np.int64) + (r_cfg.n_img_tokens or 0)
    for _ in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = R.lm_decode_step(params, r_cfg, jnp.asarray(tok),
                                         jnp.asarray(pos, np.int32), cache)
        t_logits, t_cache = T.lm_decode_step(model, t_cfg, torch.from_numpy(tok).long(),
                                             torch.from_numpy(pos), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    _check_caches(t_cache, cache, r_cfg)
    return pos, t_cache


def test_gemma3_published_window_prefill_ring_and_decode():
    """One window layer and one global layer; the long row passes the
    window, so the window layer's cache is the ring of the last 1,024
    positions and the decode steps write slot pos % 1,024."""
    r_cfg, t_cfg, _, _ = _weights("gemma3-12b")
    assert T.layer_windows(t_cfg) == [WINDOW, None]
    toks, lens = _batch(GEMMA_LENS, seed=5)
    pos, t_cache = _prefill_and_decode("gemma3-12b", toks, lens, None, GEMMA_MAX_LEN)
    assert toks.shape[1] > WINDOW and pos.max() > WINDOW
    assert t_cache[0]["k"].shape[2] == WINDOW          # the ring
    assert t_cache[1]["k"].shape[2] == GEMMA_MAX_LEN   # the global layer


def test_gemma3_ragged_ring_keeps_the_padded_positions_as_the_reference_does():
    """A caveat of the reference that the port keeps: a ragged prefill
    fills a window layer's ring with the padded batch's last 1,024
    positions, so the short row loses its own first keys there and
    decodes against pad keys.  Alone, the same row decodes otherwise; in
    both packages alike."""
    r_cfg, t_cfg, params, model = _weights("gemma3-12b")
    toks, lens = _batch(GEMMA_LENS, seed=5)
    short = toks[1:, :GEMMA_LENS[1]]
    tok = np.full((1, 1), 7, np.int32)
    got = {}
    for name, t, n in (("batch", toks, lens), ("alone", short, lens[1:])):
        _, cache = R.lm_prefill(params, r_cfg, jnp.asarray(t), max_len=GEMMA_MAX_LEN,
                                lengths=jnp.asarray(n))
        _, t_cache = T.lm_prefill(model, t_cfg, torch.from_numpy(t).long(),
                                  max_len=GEMMA_MAX_LEN, lengths=torch.from_numpy(n).long())
        b = len(n)
        logits, _ = R.lm_decode_step(params, r_cfg, jnp.asarray(np.repeat(tok, b, 0)),
                                     jnp.asarray(n), cache)
        t_logits, _ = T.lm_decode_step(model, t_cfg,
                                       torch.from_numpy(np.repeat(tok, b, 0)).long(),
                                       torch.from_numpy(n).long(), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        got[name] = t_logits[-1].numpy()
    assert np.abs(got["batch"] - got["alone"]).max() > 100 * TOL["atol"]


def test_internvl2_published_image_tokens_prefill_and_decode():
    """256 nonzero patch embeddings before the text: the last prompt
    position is read at 256 + length - 1 and decode starts at 256 +
    length."""
    r_cfg, _, _, _ = _weights("internvl2-76b")
    assert r_cfg.n_img_tokens == IMG_TOKENS
    toks, lens = _batch(VLM_LENS, seed=6)
    extra = _patch_embeds(r_cfg, len(lens), seed=7)
    _prefill_and_decode("internvl2-76b", toks, lens, extra, VLM_MAX_LEN)


@pytest.mark.parametrize("arch,prompts,max_len", [
    ("gemma3-12b", ["InChI=1S/C12H22O2/", "y" * 1040], 1100),
    ("internvl2-76b", ["InChI=1S/C12H22O2/", "C", "InChI=1S/H2O/h1H2"], VLM_MAX_LEN),
])
def test_engine_greedy_tokens_identical_to_reference(arch, prompts, max_len):
    """The static engines of both packages (the VLM's frontend a stub of
    zeros in both), greedy: the same tokens; gemma3's long prompt decodes
    past the window through the ring."""
    r_cfg, t_cfg, params, model = _weights(arch)
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=6, max_len=max_len,
                                               sync_every=3)).generate(prompts)
    got = Engine(t_cfg, model, ServeConfig(max_new_tokens=6, max_len=max_len,
                                           sync_every=3), device="cpu").generate(prompts)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert [r.prompt_len for r in got] == [r.prompt_len for r in want]
    assert got[0].steps == want[0].steps


# ---------------------------------------------------------------------------
# the published ratios of the families the card serves cut in depth
# ---------------------------------------------------------------------------

# name -> (arch, what replaces the smoke config's fields).  jamba: the
# published super-block's layers 0-3 (Mamba + SwiGLU, Mamba + MoE, Mamba +
# SwiGLU, attention + MoE) and its layers 2-3 (Mamba + SwiGLU, attention +
# MoE); qwen3-moe: query width 2 x d_model, 16:1 GQA, 128 experts top 8
# (d_ff 48: the published 1,536 / 4,096 of d_model)
CUTS = {
    "jamba-layers-0-3": ("jamba-1.5-large-398b",
                         dict(n_layers=4, hybrid_block=4, attn_index=3, moe_every=2)),
    "jamba-layers-2-3": ("jamba-1.5-large-398b",
                         dict(n_layers=2, hybrid_block=2, attn_index=1, moe_every=2)),
    "qwen3-moe-ratios": ("qwen3-moe-235b-a22b",
                         dict(n_layers=2, n_heads=16, head_dim=16, n_kv_heads=1,
                              n_experts=128, experts_per_token=8, d_ff=48)),
}
# a ragged batch whose long row spans three SSD chunks of the smoke's 32
CUT_LENS = (80, 45)
CUT_MAX_LEN = 96
CUT_PROMPTS = ["InChI=1S/C12H22O2/", "C",
               "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)/t1-2/m0/s1/i1+1;InChI=1S/H2O"]


def _cut_cfg(get, name):
    arch, fields = CUTS[name]
    return dataclasses.replace(get(arch).smoke(), dtype="float32", **fields)


def _cut_weights(name):
    """(reference cfg, port cfg, reference params, port model), cached."""
    if name not in _WEIGHTS:
        r_cfg, t_cfg = _cut_cfg(r_get_config, name), _cut_cfg(get_config, name)
        params, _ = r_build_model(r_cfg).init(jax.random.PRNGKey(17))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[name] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[name]


def _check_cut_caches(t_cache, cache, r_cfg):
    """Every layer's cache: K/V at an attention layer, the SSM state and
    the convolution tail at a Mamba layer (the hybrid's reference stacks
    them by super-block, then by Mamba position)."""
    assert len(t_cache) == r_cfg.n_layers
    for i, layer in enumerate(t_cache):
        if r_cfg.family != "hybrid":
            want = {n: cache["pos0"][n][i] for n in ("k", "v")}
        else:
            blk, j = divmod(i, r_cfg.hybrid_block)
            if j == r_cfg.attn_index:
                want = {n: cache["attn"][n][blk] for n in ("k", "v")}
            else:
                mi = [m for m in range(r_cfg.hybrid_block) if m != r_cfg.attn_index].index(j)
                want = {n: cache["mamba"][n][blk, mi] for n in ("ssm", "conv")}
        assert sorted(layer) == sorted(want)
        for n, w in want.items():
            assert tuple(layer[n].shape) == w.shape, n
            np.testing.assert_allclose(layer[n].numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("name", list(CUTS))
def test_published_ratio_cut_prefill_caches_and_decode(name):
    """A ragged prefill (logits and every layer's cache), then decode steps
    fed the reference's greedy tokens, their logits and the caches after."""
    r_cfg, t_cfg, params, model = _cut_weights(name)
    if r_cfg.family == "hybrid":
        assert r_cfg.n_layers == r_cfg.hybrid_block and max(CUT_LENS) > 2 * r_cfg.ssm_chunk
    else:
        assert r_cfg.n_heads * r_cfg.resolved_head_dim == 2 * r_cfg.d_model
        assert r_cfg.n_heads // r_cfg.n_kv_heads == 16
    r_api, t_api = r_build_model(r_cfg), build_model(t_cfg)
    toks, lens = _batch(CUT_LENS, seed=9)
    logits, cache = r_api.prefill(params, {"tokens": jnp.asarray(toks),
                                           "lengths": jnp.asarray(lens)},
                                  max_len=CUT_MAX_LEN)
    t_logits, t_cache = t_api.prefill(model, {"tokens": torch.from_numpy(toks).long(),
                                              "lengths": torch.from_numpy(lens).long()},
                                      max_len=CUT_MAX_LEN)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
    _check_cut_caches(t_cache, cache, r_cfg)
    pos = lens.astype(np.int64)
    for _ in range(DECODE_STEPS):
        tok = np.asarray(jnp.argmax(logits, -1))[:, None].astype(np.int32)
        logits, cache = r_api.decode_step(params, jnp.asarray(tok),
                                          jnp.asarray(pos, np.int32), cache)
        t_logits, t_cache = t_api.decode_step(model, torch.from_numpy(tok).long(),
                                              torch.from_numpy(pos), t_cache)
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(logits), **TOL)
        pos = pos + 1
    _check_cut_caches(t_cache, cache, r_cfg)


@pytest.mark.parametrize("name", list(CUTS))
def test_published_ratio_cut_engine_tokens_identical_to_reference(name):
    """The static engines' greedy tokens; the long prompt spans three SSD
    chunks."""
    r_cfg, t_cfg, params, model = _cut_weights(name)
    want = REngine(r_cfg, params, RServeConfig(max_new_tokens=6, max_len=CUT_MAX_LEN,
                                               sync_every=3)).generate(CUT_PROMPTS)
    got = Engine(t_cfg, model, ServeConfig(max_new_tokens=6, max_len=CUT_MAX_LEN,
                                           sync_every=3), device="cpu").generate(CUT_PROMPTS)
    assert [r.token_ids for r in got] == [r.token_ids for r in want]
    assert got[0].steps == want[0].steps


# internvl2 through the continuous engine: blocks of 24 rows, so the 256
# image positions end 16 rows into block 10; 3 slots for 4 requests; the
# longest prompt (50 bytes, 51 tokens with BOS) plus the image positions
# and its budget fills the 13 blocks of its table exactly
VLM_BLOCK = 24
VLM_BLOCKS_PER_SEQ = 13
VLM_NEW_TOKENS = 6
VLM_CONT_PROMPTS = ["InChI=1S/C12H22O2/", "C", "InChI=1S/H2O/h1H2",
                    "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)/t1-2/m0/s1/"]


def test_internvl2_continuous_engine_equals_static_and_reference():
    r_cfg, t_cfg, params, model = _weights("internvl2-76b")
    max_len = VLM_BLOCKS_PER_SEQ * VLM_BLOCK
    longest = max(len(p.encode()) + 1 for p in VLM_CONT_PROMPTS)
    assert IMG_TOKENS % VLM_BLOCK and IMG_TOKENS + longest + VLM_NEW_TOKENS - 1 == max_len
    geom = dict(n_blocks=3 * VLM_BLOCKS_PER_SEQ + 2, block_size=VLM_BLOCK, max_slots=3,
                max_blocks_per_seq=VLM_BLOCKS_PER_SEQ)
    want = RContinuousEngine(r_cfg, params, RK.PagedCacheSpec(**geom),
                             RServeConfig(max_new_tokens=VLM_NEW_TOKENS, max_len=max_len))
    eng = ContinuousEngine(t_cfg, model, TK.PagedCacheSpec(**geom),
                           ServeConfig(max_new_tokens=VLM_NEW_TOKENS, max_len=max_len),
                           prefix_cache=True, device="cpu")
    try:
        assert eng._index is None          # image positions: no prefix sharing
        got = [r.token_ids for r in eng.generate(VLM_CONT_PROMPTS)]
        static = Engine(t_cfg, model, ServeConfig(max_new_tokens=VLM_NEW_TOKENS,
                                                  max_len=max_len), device="cpu")
        assert got == [r.token_ids for r in static.generate(VLM_CONT_PROMPTS)]
        assert got == [r.token_ids for r in want.generate(VLM_CONT_PROMPTS)]
        assert all(len(row) == VLM_NEW_TOKENS for row in got)
        assert eng.counters()["completed"] == len(VLM_CONT_PROMPTS)
        eng.close(drain=True)
        eng.check()
        assert eng._mgr.stats()["in_use"] == 0
    finally:
        eng.close()
        want.close()
