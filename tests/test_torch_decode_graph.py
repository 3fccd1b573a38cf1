"""The decode step that a CUDA graph captures, run op by op on the CPU.

``Engine(decode="static")`` runs the static-buffer step (``_static_step``
over one ``_StaticDecode`` per capture key) that ``decode="graph"``
captures on the card.  Its greedy tokens must equal the eager step's and
the reference ``Engine``'s for the dense (also with sliding-window
layers), VLM, MoE, SSM, hybrid and encoder-decoder smoke configs in
float32 (weights drawn by the reference
and loaded through the parameter bridge), over two ``generate`` calls with
different prompts at one key (stale buffers would show) and at a second
batch size (a second key).  ``ContinuousEngine(decode="static")`` (static
lanes, block tables refreshed in place) must equal its eager paged step
through evictions and admissions that rewrite the tables.  Also: the
sampled static steps of both engines draw as the eager ones do, a step under
``models.moe.monitor`` runs eagerly, and the mode checks.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.models.registry import build_model as r_build_model
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro_torch.configs import get_config
from repro_torch.models.moe import monitor
from repro_torch.models.weights import params_from_reference
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvcache import PagedCacheSpec
from repro_torch.serve.scheduler import ContinuousEngine

FAMILIES = ["yi-6b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "jamba-1.5-large-398b",
            "whisper-small"]
# the ring-buffer caches of sliding-window layers, and the VLM's image
# positions before the text
MORE = ["gemma3-12b", "internvl2-76b"]
PROMPTS_A = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)",
             "C", "InChI=1S/H2O/h1H2"]
PROMPTS_B = ["CC(=O)Oc1ccccc1C(=O)O", "InChI=1S/CH4/h1H4", "N#N",
             "InChI=1S/C6H6/c1-2-4-6-5-3-1/h1-6H" + "y" * 31]  # past gemma3's window
PROMPTS_C = ["O=C=O", "InChI=1S/C2H6O/c1-2-3/h3H,2H2,1H3"]
N_NEW, MAX_LEN = 10, 96


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
    """(reference cfg, port cfg, reference params, port model): ``arch``'s
    smoke config in float32, drawn by the reference."""
    if arch not in _WEIGHTS:
        r_cfg = dataclasses.replace(r_get_config(arch).smoke(), dtype="float32")
        t_cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        params, _ = r_build_model(r_cfg).init(jax.random.PRNGKey(3))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[arch] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[arch]


def _scfg(**kw):
    return ServeConfig(max_new_tokens=N_NEW, max_len=MAX_LEN, sync_every=4, **kw)


def _tokens(engine, prompts):
    return [r.token_ids for r in engine.generate(prompts)]


@pytest.mark.parametrize("arch", FAMILIES + MORE)
def test_static_step_equals_eager_and_reference(arch):
    r_cfg, t_cfg, params, model = _weights(arch)
    static = Engine(t_cfg, model, _scfg(), device="cpu", decode="static")
    eager = Engine(t_cfg, model, _scfg(), device="cpu", decode="eager")
    ref = REngine(r_cfg, params, RServeConfig(max_new_tokens=N_NEW, max_len=MAX_LEN,
                                              sync_every=4))
    for i, prompts in enumerate((PROMPTS_A, PROMPTS_B, PROMPTS_C)):
        got = _tokens(static, prompts)
        assert got == _tokens(eager, prompts), (arch, i)
        assert got == [r.token_ids for r in ref.generate(prompts)], (arch, i)
        # one static set per (B, max_len, ...): B = 4 twice, then B = 2
        assert len(static._static) == (1 if i < 2 else 2)
    assert static.captures == static.replays == 0
    assert eager._static == {}


def test_static_step_resets_its_buffers_between_requests():
    """A request that stops at EOS early leaves ``done`` set and the token
    buffer padded; the next request on the same buffers must not see it."""
    _, t_cfg, _, model = _weights("yi-6b")
    static = Engine(t_cfg, model, _scfg(), device="cpu", decode="static")
    eager = Engine(t_cfg, model, _scfg(), device="cpu", decode="eager")
    first = static.generate(PROMPTS_A)
    st = next(iter(static._static.values()))
    assert int(st.t) == first[0].steps
    st.done.fill_(True)       # as if every row had stopped
    st.cache[0]["k"].fill_(7.0)  # rows of an earlier request
    assert _tokens(static, PROMPTS_B) == _tokens(eager, PROMPTS_B)


def test_static_sampled_step_draws_as_the_eager_one():
    _, t_cfg, _, model = _weights("yi-6b")
    scfg = _scfg(greedy=False, seed=5, temperature=0.8)
    static = Engine(t_cfg, model, scfg, device="cpu", decode="static")
    eager = Engine(t_cfg, model, scfg, device="cpu", decode="eager")
    for prompts in (PROMPTS_A, PROMPTS_B):
        assert _tokens(static, prompts) == _tokens(eager, prompts)


def test_moe_step_under_the_monitor_runs_eagerly():
    _, t_cfg, _, model = _weights("moonshot-v1-16b-a3b")
    static = Engine(t_cfg, model, _scfg(), device="cpu", decode="static")
    want = _tokens(static, PROMPTS_A)
    static._static.clear()
    with monitor(model) as calls:
        got = _tokens(static, PROMPTS_A)
    assert got == want
    assert static._static == {}      # no static buffers were made
    n_moe = sum(1 for c in calls)
    assert n_moe > t_cfg.n_layers    # the prefill's and every decode step's


def test_decode_mode_checks():
    _, t_cfg, _, model = _weights("yi-6b")
    assert Engine(t_cfg, model, _scfg(), device="cpu").decode == "eager"
    with pytest.raises(ValueError, match="CUDA"):
        Engine(t_cfg, model, _scfg(), device="cpu", decode="graph")
    with pytest.raises(ValueError, match="one of"):
        Engine(t_cfg, model, _scfg(), device="cpu", decode="fused")
    spec = PagedCacheSpec(n_blocks=33, block_size=8, max_slots=3, max_blocks_per_seq=10)
    eng = ContinuousEngine(t_cfg, model, spec, _scfg(), device="cpu")
    assert eng.decode == "eager"
    eng.close()
    sampled = ContinuousEngine(t_cfg, model, spec, _scfg(greedy=False), device="cpu",
                               decode="static")
    assert sampled.decode == "static"
    sampled.close()
    with pytest.raises(ValueError, match="CUDA"):
        ContinuousEngine(t_cfg, model, spec, _scfg(), device="cpu", decode="graph")


def _continuous_through_evictions(model, t_cfg, scfg):
    """Six ragged requests through three lanes, eager and static: finished
    sequences are evicted and queued ones admitted into their lanes, which
    rewrites the block tables (and the lanes' seeds and token indices)
    while the others decode.  Returns each mode's tokens."""
    spec = PagedCacheSpec(n_blocks=33, block_size=8, max_slots=3, max_blocks_per_seq=10)
    texts = PROMPTS_A + PROMPTS_C
    budgets = [3, 10, 5, 8, 2, 9]
    out = {}
    for mode in ("eager", "static"):
        eng = ContinuousEngine(t_cfg, model, spec, scfg, device="cpu",
                               prefix_cache=False, decode=mode)
        futs = [eng.submit(t, n, lead=False, seed=20 + i)
                for i, (t, n) in enumerate(zip(texts, budgets))]
        eng._maybe_lead()
        out[mode] = [f.result(timeout=300).token_ids for f in futs]
        assert eng.stats.completed == len(texts) and eng.stats.peak_active == 3
        eng.check()
        eng.close()
    assert out["static"] == out["eager"]
    return texts, budgets, out


def test_continuous_static_lanes_equal_eager_through_evictions():
    _, t_cfg, _, model = _weights("yi-6b")
    texts, budgets, out = _continuous_through_evictions(model, t_cfg, _scfg())
    static = Engine(t_cfg, model, _scfg(), device="cpu", decode="eager")
    for t, n, got in zip(texts, budgets, out["static"]):
        assert got == _tokens(static, [t])[0][:n]


def test_continuous_sampled_static_lanes_equal_eager_through_evictions():
    """The sampled lane step (each lane's key from its request's seed and
    token index, top-k) under ``"static"`` draws what the eager step draws,
    through the same evictions and admissions; the tokens are not the
    greedy ones."""
    _, t_cfg, _, model = _weights("yi-6b")
    scfg = _scfg(greedy=False, temperature=0.9, top_k=40)
    _, _, out = _continuous_through_evictions(model, t_cfg, scfg)
    _, _, greedy = _continuous_through_evictions(model, t_cfg, _scfg())
    assert out["static"] != greedy["static"]
