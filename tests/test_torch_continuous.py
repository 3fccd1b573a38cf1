"""Continuous batching of the port against the reference's, on the CPU:
the paged KV cache (``serve/kvcache.py``), the paged model functions
(``models/common.py``, ``models/transformer.py``) and ``ContinuousEngine``
(``serve/scheduler.py``).  It mirrors the reference's
``tests/test_continuous_batching.py`` and ``tests/test_prefix_cache.py``.

* The allocator and the prefix index are copies: under the same operation
  sequences the port's and the reference's hold the same state.
* Paged decode equals dense decode bit for bit, and suffix prefill equals
  full prefill bit for bit (the plain attention on the CPU), as in the
  reference; both are within 1e-4 of the reference's in float32.
* ``ContinuousEngine``'s greedy tokens equal the reference's
  ``ContinuousEngine``'s and the port's static ``Engine``'s, and prefix
  sharing on equals off (float32 weights drawn by the reference).
* Backpressure, an oversized request, ``close``, threads, sampling that
  depends on (prompt, seed) only, and the families that have no paged
  path.
"""

import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.models import common as RC
from repro.models.registry import build_model as r_build_model
from repro.serve import kvcache as RK
from repro.serve.scheduler import ContinuousEngine as RContinuousEngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch.configs import get_config
from repro_torch.models import common as TC
from repro_torch.models.registry import build_model
from repro_torch.models.weights import params_from_reference
from repro_torch.serve import kvcache as TK
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.sampling import fold_in, prng_key
from repro_torch.serve.scheduler import ContinuousEngine, EngineClosed

TOL = dict(atol=1e-4, rtol=1e-4)
MAX_LEN, BS = 64, 8
STEM = "InChI=1S/C8H9NO2/c1-6(10)9-7-2-4-8(11)5-3-7;"
SHARED = [STEM + tail for tail in ("a1", "b22", "c333", "a1")]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _tiny(get, dtype="float32", **kw):
    base = dataclasses.replace(
        get("yi-6b"), n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=300, dtype=dtype)
    return dataclasses.replace(base, **kw)


_MODELS = {}


def _weights(dtype="float32", arch=None):
    """(reference cfg, port cfg, reference params, port model): the tiny
    yi-6b config (or ``arch``'s smoke config) drawn by the reference."""
    key = (dtype, arch)
    if key not in _MODELS:
        if arch is None:
            r_cfg, t_cfg = _tiny(r_get_config, dtype), _tiny(get_config, dtype)
        else:
            r_cfg = dataclasses.replace(r_get_config(arch).smoke(), dtype=dtype)
            t_cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
        params, _ = r_build_model(r_cfg).init(jax.random.PRNGKey(0))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _MODELS[key] = (r_cfg, t_cfg, params,
                        params_from_reference(t_cfg, named, device="cpu"))
    return _MODELS[key]


def _spec(mod=TK, **kw):
    base = dict(n_blocks=33, block_size=BS, max_slots=3,
                max_blocks_per_seq=MAX_LEN // BS)
    base.update(kw)
    return mod.PagedCacheSpec(**base)


def _engine(spec=None, scfg=None, prefix_cache=True, dtype="float32"):
    _, cfg, _, model = _weights(dtype)
    return ContinuousEngine(cfg, model, spec or _spec(),
                            scfg or ServeConfig(max_new_tokens=20, max_len=MAX_LEN),
                            prefix_cache=prefix_cache, device="cpu")


def _static(max_len=MAX_LEN, n=20):
    _, cfg, _, model = _weights()
    return Engine(cfg, model, ServeConfig(max_new_tokens=n, max_len=max_len),
                  device="cpu")


# ---------------------------------------------------------------------------
# the allocator and the prefix index: the reference's state
# ---------------------------------------------------------------------------

def _mgr_state(m):
    return (list(m._free), sorted(m._allocated), dict(m._refcounts),
            m.tables.tolist(), {k: list(v) for k, v in m._slot_blocks.items()},
            m.stats())


def _call(obj, name, *args, **kw):
    try:
        return ("ok", getattr(obj, name)(*args, **kw))
    except (ValueError, AssertionError) as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("seed", range(4))
def test_block_manager_state_equals_reference_under_random_ops(seed):
    rng = np.random.default_rng(seed)
    spec_kw = dict(n_blocks=24, max_slots=4, max_blocks_per_seq=6)
    r, t = RK.BlockManager(_spec(RK, **spec_kw)), TK.BlockManager(_spec(TK, **spec_kw))
    held = []  # raw allocations
    for _ in range(300):
        op = rng.integers(0, 8)
        slot = int(rng.integers(0, 4))
        if op == 0:
            n = int(rng.integers(0, 5))
            calls = [("alloc", (n,), {})]
        elif op == 1 and held:
            blocks = held.pop(int(rng.integers(0, len(held))))
            calls = [("free", (blocks,), {})]
        elif op == 2:
            prefix = r.slot_blocks(int(rng.integers(0, 4)))[: int(rng.integers(0, 3))]
            calls = [("admit", (slot, int(rng.integers(1, 50))),
                      {"prefix_blocks": prefix})]
        elif op == 3:
            calls = [("release", (slot,), {})]
        elif op == 4:
            calls = [("grow", (slot, int(rng.integers(1, 50))), {})]
        elif op == 5:
            calls = [("fork", (slot, int(rng.integers(0, 4))), {})]
        elif op == 6:
            calls = [("can_admit", (int(rng.integers(1, 60)),),
                      {"n_adopted": int(rng.integers(0, 3))})]
        else:
            calls = [("check", (), {})]
        for name, args, kw in calls:
            got, want = _call(t, name, *args, **kw), _call(r, name, *args, **kw)
            assert got == want, (name, args)
            if name == "alloc" and got[0] == "ok" and got[1]:
                held.append(got[1])
        assert _mgr_state(t) == _mgr_state(r)


def test_prefix_index_state_equals_reference():
    rng = np.random.default_rng(1)
    kw = dict(n_blocks=30, max_slots=3, max_blocks_per_seq=6)
    mr, mt = RK.BlockManager(_spec(RK, **kw)), TK.BlockManager(_spec(TK, **kw))
    ir, it = RK.PrefixIndex(mr, max_entries=12), TK.PrefixIndex(mt, max_entries=12)
    stems = [list(rng.integers(0, 259, 30)) for _ in range(3)]
    for step in range(120):
        slot = step % 3
        prompt = stems[int(rng.integers(0, 3))][: int(rng.integers(5, 30))] + \
            list(rng.integers(0, 259, int(rng.integers(0, 9))))
        got, want = it.match(prompt), ir.match(prompt)
        assert got == want
        if slot in mr._slot_blocks:
            assert _call(mt, "release", slot) == _call(mr, "release", slot)
        total = len(prompt) + 4
        a = _call(mt, "admit", slot, total, prefix_blocks=got[0])
        assert a == _call(mr, "admit", slot, total, prefix_blocks=want[0])
        if a == ("ok", True):
            assert (it.publish(prompt, mt.slot_blocks(slot), len(prompt))
                    == ir.publish(prompt, mr.slot_blocks(slot), len(prompt)))
        if step % 7 == 0:
            assert it.evict_for(3) == ir.evict_for(3)
        assert it.stats() == ir.stats()
        assert list(it._entries.items()) == list(ir._entries.items())
        assert it.block_refs() == ir.block_refs()
        assert _mgr_state(mt) == _mgr_state(mr)
        mt.check(it.block_refs())
    assert it.clear() == ir.clear()
    assert _mgr_state(mt) == _mgr_state(mr)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 64])
def test_rolling_hashes_and_blocks_for_equal_reference(n):
    toks = list(np.random.default_rng(n).integers(0, 2**40, n))
    assert TK.rolling_block_hashes(toks, 8, n // 8) == RK.rolling_block_hashes(toks, 8, n // 8)
    assert TK.blocks_for(n, 8) == RK.blocks_for(n, 8)
    assert TK._mix64(n) == RK._mix64(n)


def test_alloc_free_double_free_and_trash():
    mgr = TK.BlockManager(_spec(n_blocks=6, max_slots=2, max_blocks_per_seq=4))
    blocks = mgr.alloc(3)
    assert blocks is not None and TK.TRASH_BLOCK not in blocks
    mgr.free(blocks)
    with pytest.raises(ValueError, match="double free"):
        mgr.free(blocks)
    with pytest.raises(ValueError, match="trash"):
        mgr.free([TK.TRASH_BLOCK])
    assert mgr.alloc(6) is None and mgr.alloc_failures == 1
    mgr.check()


def test_fork_and_shared_blocks():
    mgr = TK.BlockManager(_spec(n_blocks=9, max_slots=2, max_blocks_per_seq=4))
    assert mgr.admit(0, 17)
    shared = mgr.slot_blocks(0)
    assert mgr.admit(1, 17, prefix_blocks=shared[:2])
    with pytest.raises(ValueError, match="shared"):
        mgr.free([shared[0]])
    assert mgr.fork(1, 2)[0] == mgr.fork(1, 2)[1]      # exclusive: no-op
    old, new = mgr.fork(1, 0)
    assert old == shared[0] != new and mgr.tables[1][0] == new
    mgr.check({})


def test_index_collision_is_a_miss_and_eviction_spares_shared():
    mgr = TK.BlockManager(_spec(n_blocks=17))
    idx = TK.PrefixIndex(mgr)
    pa, pb = [1] * 9, [2] * 9
    assert mgr.admit(0, 9) and mgr.admit(1, 9)
    idx.publish(pa, mgr.slot_blocks(0), 9)
    idx.publish(pb, mgr.slot_blocks(1), 9)
    mgr.release(0)
    idx.match(pa + [3])                     # pb's entry is now the LRU
    assert idx.evict_for(1) == 1            # pb's block is shared: skipped
    assert mgr.refcount(mgr.slot_blocks(1)[0]) == 2
    key = TK.rolling_block_hashes(pb, BS, 1)[0]
    tokens, chain = idx._entries[key]
    idx._entries[key] = ((999,) * len(tokens), chain)
    assert idx.match(pb) == ([], 0) and idx.hash_collisions == 1
    mgr.check(idx.block_refs())


# ---------------------------------------------------------------------------
# the paged model functions
# ---------------------------------------------------------------------------

PROMPT = [256] + list(b"InChI=1S/C8H9NO2/c1-6(")   # 24 tokens: 3 blocks


def _prefill(api, model, prompt, max_len=MAX_LEN, long=torch.long):
    bucket = -(-len(prompt) // BS) * BS
    toks = np.full((1, bucket), 258, np.int64)
    toks[0, :len(prompt)] = prompt
    return api.prefill(model, {"tokens": torch.from_numpy(toks),
                               "lengths": torch.tensor([len(prompt)])},
                       max_len=max_len)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_bitwise_vs_dense(dtype):
    """One prefill of a 3-row batch; its row 1 decodes through the dense
    cache (all rows live) and through slot 1 of a 3-slot paged batch (slots
    0 and 2 inactive: all-trash tables, pos 0).  Same shapes, so row 1's
    logits are equal bit for bit: inactive lanes do not perturb it."""
    _, cfg, _, model = _weights(dtype)
    api = build_model(cfg)
    spec = _spec()
    mgr = TK.BlockManager(spec)
    n = 12
    toks = torch.tensor([PROMPT[:n]] * 3)
    logits, dense = api.prefill(model, {"tokens": toks, "lengths": torch.tensor([n] * 3)},
                                max_len=MAX_LEN)
    pool = api.paged_cache_init(spec.n_blocks, BS, "cpu")
    assert mgr.admit(1, n + 7)
    api.paged_prefill_write(pool, [{k: t[1:2] for k, t in c.items()} for c in dense],
                            torch.from_numpy(mgr.tables[1]), BS)
    cur = torch.argmax(logits, -1)[:, None]
    pos = torch.tensor([n] * 3)
    p_cur = torch.zeros((3, 1), dtype=torch.long)
    p_cur[1] = cur[1]
    p_pos = torch.tensor([0, n, 0])
    tables = torch.from_numpy(mgr.tables)
    for _ in range(6):
        lg, dense = api.decode_step(model, cur, pos, dense)
        p_lg, pool = api.decode_step_paged(model, p_cur, p_pos, tables, pool, BS)
        assert torch.equal(p_lg[1], lg[1])
        cur, pos = torch.argmax(lg, -1)[:, None], pos + 1
        p_cur[1, 0] = torch.argmax(p_lg[1])
        p_pos[1] += 1


def test_paged_decode_matches_reference():
    r_cfg, cfg, params, model = _weights()
    r_api, api = r_build_model(r_cfg), build_model(cfg)
    spec, r_spec = _spec(), _spec(RK)
    mgr, r_mgr = TK.BlockManager(spec), RK.BlockManager(r_spec)
    prompts = [PROMPT[:12], PROMPT[:20]]
    pool = api.paged_cache_init(spec.n_blocks, BS, "cpu")
    r_pool, _ = r_api.paged_cache_init(r_spec.n_blocks, BS)
    cur, pos = np.zeros((3, 1), np.int64), np.zeros(3, np.int64)
    for slot, p in enumerate(prompts):
        assert mgr.admit(slot, len(p) + 8) and r_mgr.admit(slot, len(p) + 8)
        lg, dense = _prefill(api, model, p)
        toks = np.full((1, -(-len(p) // BS) * BS), 258, np.int32)
        toks[0, :len(p)] = p
        r_lg, r_dense = r_api.prefill(params, {"tokens": jnp.asarray(toks),
                                               "lengths": jnp.asarray([len(p)])},
                                      max_len=MAX_LEN)
        np.testing.assert_allclose(lg.numpy(), np.asarray(r_lg), **TOL)
        api.paged_prefill_write(pool, dense, torch.from_numpy(mgr.tables[slot]), BS)
        r_pool = r_api.paged_prefill_write(r_pool, r_dense,
                                           jnp.asarray(r_mgr.tables[slot]), BS)
        cur[slot, 0], pos[slot] = int(np.argmax(np.asarray(r_lg)[0])), len(p)
    for _ in range(5):
        lg, pool = api.decode_step_paged(model, torch.from_numpy(cur),
                                         torch.from_numpy(pos),
                                         torch.from_numpy(mgr.tables), pool, BS)
        r_lg, r_pool = r_api.decode_step_paged(
            params, jnp.asarray(cur, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(r_mgr.tables), r_pool, BS)
        np.testing.assert_allclose(lg[:2].numpy(), np.asarray(r_lg)[:2], **TOL)
        cur[:2, 0] = np.argmax(np.asarray(r_lg)[:2], -1)
        pos[:2] += 1
    for layer in range(cfg.n_layers):
        np.testing.assert_allclose(pool[layer]["k"].numpy(),
                                   np.asarray(r_pool["pos0"]["k"][layer]), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_suffix_prefill_bitwise_vs_full_and_near_reference(dtype):
    r_cfg, cfg, params, model = _weights(dtype)
    r_api, api = r_build_model(r_cfg), build_model(cfg)
    spec = _spec()
    pool = api.paged_cache_init(spec.n_blocks, BS, "cpu")
    r_pool, _ = r_api.paged_cache_init(spec.n_blocks, BS)
    n = len(PROMPT)
    toks = np.full((1, 24), 258, np.int64)
    toks[0, :n] = PROMPT
    full, dense = _prefill(api, model, PROMPT)
    r_full, r_dense = r_api.prefill(params, {"tokens": jnp.asarray(toks, jnp.int32),
                                             "lengths": jnp.asarray([n])},
                                    max_len=MAX_LEN)
    row_pub = np.zeros(MAX_LEN // BS, np.int32)
    row_pub[:3] = [1, 2, 3]
    api.paged_prefill_write(pool, dense, torch.from_numpy(row_pub), BS)
    r_pool = r_api.paged_prefill_write(r_pool, r_dense, jnp.asarray(row_pub), BS)
    for start in (8, 16):
        row = row_pub.copy()
        row[start // BS:3] = [4, 5][: 3 - start // BS]
        got, pool = api.prefill_suffix(model, torch.from_numpy(toks[:, start:]),
                                       start, torch.from_numpy(row), pool, BS,
                                       lengths=torch.tensor([n - start]))
        assert torch.equal(got, full), f"suffix != full prefill at start={start}"
        if dtype == "float32":
            want, r_pool = r_api.prefill_suffix(
                params, jnp.asarray(toks[:, start:], jnp.int32), start,
                jnp.asarray(row), r_pool, BS, lengths=jnp.asarray([n - start]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="multiple of block_size"):
        api.prefill_suffix(model, torch.from_numpy(toks[:, 5:]), 5,
                           torch.from_numpy(row_pub), pool, BS)


def test_paged_view_and_write_rows_match_reference():
    rng = np.random.default_rng(4)
    pool = rng.standard_normal((2, 10 * 4, 3)).astype(np.float32)
    tables = np.array([[3, 1, 0], [2, 0, 0]], np.int32)
    np.testing.assert_array_equal(
        TC.paged_view(torch.from_numpy(pool), torch.from_numpy(tables), 4).numpy(),
        np.asarray(RC.paged_view(jnp.asarray(pool), jnp.asarray(tables), 4)))
    rows = rng.standard_normal((2, 5, 3)).astype(np.float32)
    for start in (0, 4):
        want = RC.paged_write_rows(jnp.asarray(pool), jnp.asarray(rows),
                                   jnp.asarray(tables[0]), 4, start=start)
        got = TC.paged_write_rows(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                                  torch.from_numpy(tables[0]), 4, start=start)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(IndexError):  # past the table: raises, never clamps
        TC.paged_write_rows(torch.from_numpy(pool.copy()), torch.from_numpy(rows),
                            torch.from_numpy(tables[0]), 4, start=8)


# ---------------------------------------------------------------------------
# the continuous engine
# ---------------------------------------------------------------------------

def test_greedy_tokens_equal_reference_continuous_and_static():
    r_cfg, _, params, _ = _weights()
    texts = ["InChI=1S/", "C6H12O6/c", "smiles:CC", "InChI=1S/C4H10/c1-3-4-2"]
    want = RContinuousEngine(r_cfg, params, _spec(RK),
                             RServeConfig(max_new_tokens=12, max_len=MAX_LEN))
    eng = _engine(scfg=ServeConfig(max_new_tokens=12, max_len=MAX_LEN))
    try:
        got = [r.token_ids for r in eng.generate(texts)]
        assert got == [r.token_ids for r in want.generate(texts)]
        assert got == [r.token_ids for r in _static(n=12).generate(texts)]
        eng.check()
    finally:
        eng.close()
        want.close()


def test_ragged_budgets_match_serial_and_pool_drains():
    eng = _engine()
    static = _static()
    ragged = ["ab", "InChI=1S/C4H10/c1-3-4-2", "xy", "C1=CC=CC=C1O"]
    budgets = [3, 20, 5, 9]
    futs = [eng.submit(t, b, lead=False) for t, b in zip(ragged, budgets)]
    eng._maybe_lead()
    got = [f.result(timeout=300).token_ids for f in futs]
    for t, b, g in zip(ragged, budgets, got):
        assert g == static.generate([t])[0].token_ids[:b]
    eng.check()
    assert eng._mgr.stats()["in_use"] == len(eng._index.block_refs())
    eng._index.clear()
    st = eng._mgr.stats()
    assert st["in_use"] == 0 and st["allocs"] == st["frees"]
    eng.close()


def test_prefix_on_equals_off_with_hits():
    spec = _spec(n_blocks=65, max_slots=3, max_blocks_per_seq=8)
    scfg = ServeConfig(max_new_tokens=8, max_len=MAX_LEN)
    on = _engine(spec, scfg, prefix_cache=True)
    off = _engine(spec, scfg, prefix_cache=False)
    try:
        want = [r.token_ids for r in off.generate(SHARED)]
        got = [r.token_ids for r in on.generate(SHARED)]
        assert got == want, "prefix sharing changed the tokens"
        assert on.stats.prefix_hits >= len(SHARED) - 1
        assert on.stats.prefill_tokens_saved >= 32 * (len(SHARED) - 1)
        c = on.counters()
        assert c["prefix_hit_rate"] > 0 and c["pfx_entries"] > 0
        assert off.stats.prefix_hits == 0 and "pfx_entries" not in off.counters()
        on.check()
        off.check()
    finally:
        on.close()
        off.close()


def test_reused_blocks_decode_identically_to_fresh():
    scfg = ServeConfig(max_new_tokens=10, max_len=MAX_LEN)
    churned, fresh = _engine(scfg=scfg), _engine(scfg=scfg)
    churned.generate(["InChI=1S/C4H10", "xylene", "C6H6"])
    assert churned._mgr.stats()["frees"] > 0
    probe = ["InChI=1S/C8H9NO2/", "ab"]
    assert ([r.token_ids for r in churned.generate(probe)]
            == [r.token_ids for r in fresh.generate(probe)])
    churned.check()
    churned.close()
    fresh.close()


def test_pool_exhaustion_is_admission_backpressure():
    eng = _engine(_spec(n_blocks=6, max_slots=2, max_blocks_per_seq=4),
                  ServeConfig(max_new_tokens=20, max_len=32))
    texts = ["InChI=1S/C4", "C1=CC=CC=C1"]
    futs = [eng.submit(t, 20, lead=False) for t in texts]
    eng._maybe_lead()
    got = [f.result(timeout=300).token_ids for f in futs]
    assert eng.stats.admission_stalls > 0 and eng.stats.peak_active == 1
    static = _static(max_len=32)
    for t, g in zip(texts, got):
        assert g == static.generate([t])[0].token_ids
    eng.check()
    eng.close()


def test_oversized_request_fails_cleanly():
    eng = _engine(_spec(n_blocks=4, max_slots=2, max_blocks_per_seq=4),
                  ServeConfig(max_new_tokens=8, max_len=32))
    fut = eng.submit("InChI=1S/C8H9NO2/x", 13)
    with pytest.raises(RuntimeError, match="usable"):
        fut.result(timeout=60)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit("x" * 30, 8).result(timeout=60)
    with pytest.raises(ValueError, match=">= 1"):
        eng.submit("x", -1).result(timeout=60)
    assert len(eng.submit("ab", 4).result(timeout=300).token_ids) <= 4
    assert eng.stats.failed == 1
    eng.close()


def test_concurrent_submits_from_threads_and_slo():
    """More client threads than cores, a short switch interval: every
    request completes with the serial tokens, counters add up."""
    eng = _engine()
    static = _static()
    texts = ["InChI=1S/", "C6H12O6/c", "smiles:CC"] * 4
    want = {t: static.generate([t])[0].token_ids[:8] for t in set(texts)}
    outs = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i, t):
            outs[i] = eng.submit(t, 8).result(timeout=300)

        ths = [threading.Thread(target=worker, args=(i, t)) for i, t in enumerate(texts)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    for i, t in enumerate(texts):
        assert outs[i].token_ids == want[t]
    slo = eng.slo_ms()
    assert slo["ttft_p50_ms"] > 0 and slo["itl_p50_ms"] > 0
    assert eng.stats.completed == eng.stats.requests == len(texts)
    assert eng.counters()["tokens_out"] == sum(len(o.token_ids) for o in outs.values())
    eng.check()
    eng.close()
    with pytest.raises(EngineClosed, match="closed"):
        eng.submit("ab")


def test_pool_pressure_reclaims_index_blocks():
    spec = _spec(n_blocks=11, max_slots=2, max_blocks_per_seq=5)
    scfg = ServeConfig(max_new_tokens=6, max_len=40)
    on, off = _engine(spec, scfg, True), _engine(spec, scfg, False)
    try:
        prompts = ["InChI=1S/C4H10/c1-3-4-2;x", "C1=CC=CC=C1O.C1=CC=CC=C1",
                   "InChI=1S/C4H10/c1-3-4-2;y", "benzene+toluene+xylene!!",
                   "InChI=1S/C4H10/c1-3-4-2;z"]
        futs = [on.submit(p, lead=False) for p in prompts]
        on._maybe_lead()
        got = [f.result(timeout=300).token_ids for f in futs]
        assert got == [off.generate([p])[0].token_ids for p in prompts]
        assert on.counters()["pfx_evictions"] > 0
        on.check()
    finally:
        on.close()
        off.close()


def test_close_fails_queued_with_engine_closed():
    eng = _engine(scfg=ServeConfig(max_new_tokens=4, max_len=MAX_LEN))
    futs = [eng.submit(t, lead=False) for t in ("ab", "cd", "ef")]
    eng.close()
    for f in futs:
        with pytest.raises(EngineClosed, match="never admitted"):
            f.result(timeout=60)
    assert eng.stats.cancelled == 3
    eng.close()  # a second close is a no-op


def test_close_drain_serves_everything():
    eng = _engine(scfg=ServeConfig(max_new_tokens=4, max_len=MAX_LEN))
    futs = [eng.submit(t, lead=False) for t in ("ab", "cd", "ef")]
    eng.close(drain=True)
    for f in futs:
        assert len(f.result(timeout=60).token_ids) >= 1
    assert eng.stats.completed == 3 and eng.stats.cancelled == 0
    eng.check()
    assert eng._mgr.n_in_use == len(eng._index.block_refs())


def test_sampling_independent_of_lane_composition():
    scfg = ServeConfig(max_new_tokens=10, max_len=MAX_LEN, greedy=False,
                       temperature=0.9, top_k=20)
    solo, packed = _engine(scfg=scfg), _engine(scfg=scfg)
    try:
        want = solo.submit("InChI=1S/C4", seed=7).result(timeout=300).token_ids
        futs = [packed.submit("benzene", seed=1, lead=False),
                packed.submit("InChI=1S/C4", seed=7, lead=False),
                packed.submit("xylene!", seed=2, lead=False)]
        packed._maybe_lead()
        assert futs[1].result(timeout=300).token_ids == want
        other = packed.submit("InChI=1S/C4", seed=8).result(timeout=300)
        assert other.token_ids != want  # another seed, other draws
    finally:
        solo.close()
        packed.close()


def test_sampling_reproducible_by_seed_and_top_k_one_is_greedy():
    eng = _engine(scfg=ServeConfig(max_new_tokens=8, max_len=MAX_LEN,
                                   greedy=False, temperature=1.2))
    a = eng.submit("smiles:CC", seed=3).result(timeout=300).token_ids
    b = eng.submit("smiles:CC", seed=3).result(timeout=300).token_ids
    assert a == b
    eng.close()
    top1 = _engine(scfg=ServeConfig(max_new_tokens=8, max_len=MAX_LEN,
                                    greedy=False, top_k=1))
    greedy = _engine(scfg=ServeConfig(max_new_tokens=8, max_len=MAX_LEN))
    assert (top1.submit("smiles:CC", seed=5).result(timeout=300).token_ids
            == greedy.submit("smiles:CC").result(timeout=300).token_ids)
    top1.close()
    greedy.close()
    assert ServeConfig().greedy and ServeConfig().top_k == 0
    # token k of a request seeded s draws under fold_in(PRNGKey(s), k)
    def key(s, k):
        return fold_in(prng_key(s & 0xFFFFFFFF), k).view(torch.int32).tolist()

    assert key(3, 1) == key(3, 1) != key(3, 2)
    assert key(3, 1) != key(4, 1) and key(2**40, 0) == key(0, 0)
    want = jax.random.fold_in(jax.random.PRNGKey(np.uint32(3)), 1)
    assert key(3, 1) == np.asarray(want).view(np.int32).tolist()


@pytest.mark.parametrize("arch", ["gemma3-12b", "mamba2-1.3b", "jamba-1.5-large-398b"])
def test_families_without_paged_path_rejected(arch):
    cfg = get_config(arch).smoke()
    assert not build_model(cfg).supports_paged
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="paged"):
        ContinuousEngine(cfg, model, _spec(), device="cpu")


def test_moe_serves_continuously_with_prefix_sharing_off():
    """MoE: sharing is off (capacity drops depend on the prefill's batch),
    decode never drops; with a capacity that drops nothing continuous ==
    static."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").smoke(),
                              dtype="float32", capacity_factor=4.0)
    model = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    eng = ContinuousEngine(cfg, model, _spec(),
                           ServeConfig(max_new_tokens=8, max_len=MAX_LEN),
                           prefix_cache=True, device="cpu")
    assert eng._index is None
    texts = SHARED[:2] + ["ab"]
    static = Engine(cfg, model, ServeConfig(max_new_tokens=8, max_len=MAX_LEN),
                    device="cpu")
    assert ([r.token_ids for r in eng.generate(texts)]
            == [r.token_ids for r in static.generate(texts)])
    assert eng.stats.prefix_hits == eng.stats.prefix_misses == 0
    eng.check()
    eng.close()


def test_engine_checks_the_model_device():
    cfg = _tiny(get_config)
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="engine on"):
        ContinuousEngine(cfg, model.to("meta"), _spec(), device="cpu")
