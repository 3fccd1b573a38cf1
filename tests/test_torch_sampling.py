"""The port's sampler against ``jax.random``, on the CPU.

``repro_torch.serve.sampling`` (the plain functions of
``repro_torch.kernels.sample.ref``) must give ``jax.random``'s keys, bits
and uniforms bit for bit and its Gumbel noise within 2 ulp of max(1,
|g|) (the two ``log``s are the only float functions), over shapes that include an odd
``(8, V)``, one element and more than 2**16 elements.  ``categorical`` in
the reference's two forms, the static engine's one key over the batch and
the continuous engine's per-lane ``fold_in`` keys with temperature and
top-k, must give the same tokens; a differing token passes only where the
reference's top two perturbed scores lie within ``NEAR_TIE`` of each
other, and is printed.  Then the engines: the port's sampled ``Engine``
and ``ContinuousEngine`` (float32 smoke configs, weights drawn by the
reference and loaded through the bridge) against ``repro``'s with the
same seeds: the same tokens.  Inputs are made from seeds with numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.models.registry import build_model as r_build_model
from repro.serve import kvcache as RK
from repro.serve.engine import Engine as REngine, ServeConfig as RServeConfig
from repro.serve.scheduler import ContinuousEngine as RContinuousEngine
from repro_torch.configs import get_config
from repro_torch.kernels.sample import ref as S
from repro_torch.kernels.sample.kernel import parts_for, sample_cuda
from repro_torch.kernels.sample.ops import sample
from repro_torch.models.weights import params_from_reference
from repro_torch.serve import kvcache as TK
from repro_torch.serve import sampling
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.scheduler import ContinuousEngine

SHAPES = [(8, 1001), (1,), (70001,), (3, 5, 7), (2, 40000)]
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
# two perturbed scores this close may be ordered apart by an ulp of a log:
# a few float32 ulps of a score of magnitude up to ~20
NEAR_TIE = 1e-5
PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/h2-5,10H,1H3,(H,9,11)", "C",
           "CC(=O)Oc1ccccc1C(=O)O"]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1, 2**32 - 1, -1])
def test_prng_key_split_and_fold_in_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    tk = sampling.prng_key(seed, "cpu")
    assert (_u32(tk) == np.asarray(key)).all()
    for n in (2, 3, 7):
        assert (_u32(sampling.split(tk, n)) == np.asarray(jax.random.split(key, n))).all()
    for d in (0, 1, 99, 2**31, 2**32 - 1):
        assert (_u32(sampling.fold_in(tk, d))
                == np.asarray(jax.random.fold_in(key, d))).all()
    # the chain of splits of the static engine, five steps
    jk, k = key, tk
    for _ in range(5):
        jk, _sub = jax.random.split(jk)
        k = sampling.split(k)[0]
        assert (_u32(k) == np.asarray(jk)).all()


def test_prng_key_of_seed_tensors_and_batched_fold_in():
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, 2**32, 16, dtype=np.uint32)
    idx = rng.integers(0, 1000, 16).astype(np.int32)
    want = jax.vmap(lambda s, i: jax.random.fold_in(jax.random.PRNGKey(s), i))(
        jnp.asarray(seeds), jnp.asarray(idx))
    got = sampling.fold_in(sampling.prng_key(torch.from_numpy(seeds.view(np.int32))),
                           torch.from_numpy(idx))
    assert (_u32(got) == np.asarray(want)).all()
    with pytest.raises(ValueError, match="32-bit"):
        sampling.prng_key(2**32)


@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits32_equal_jax(shape):
    key = jax.random.PRNGKey(42)
    got = _u32(sampling.random_bits32(sampling.prng_key(42), shape))
    assert got.shape == shape
    assert (got == np.asarray(jax.random.bits(key, shape, jnp.uint32))).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_equals_jax_bit_for_bit(shape, dtype):
    tdt, jdt = dtype
    key, tk = jax.random.PRNGKey(9), sampling.prng_key(9)
    for lo, hi in ((0.0, 1.0), (S.TINY, 1.0), (-2.0, 3.0)):
        got = sampling.uniform(tk, shape, tdt, lo, hi)
        assert got.dtype == tdt and tuple(got.shape) == shape
        want = _f32(jax.random.uniform(key, shape, jdt, lo, hi))
        assert (got.float().numpy() == want).all(), (lo, hi)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_within_two_ulp_of_jax(shape, dtype):
    tdt, jdt = dtype
    got = sampling.gumbel(sampling.prng_key(5), shape, tdt).float().numpy()
    want = _f32(jax.random.gumbel(jax.random.PRNGKey(5), shape, jdt))
    # an ulp of the inner log is an ulp of 1 in the outer one's result:
    # ulps are counted at max(1, |g|), the scale of the scores it joins
    scale = np.maximum(np.abs(want), np.float32(1))
    ulp = (np.spacing(scale) if tdt == torch.float32 else
           scale.astype(ml_dtypes.bfloat16).astype(np.float32) * 2.0**-7)
    assert (np.abs(got - want) <= 2 * ulp).all()


def _print_ties(name, got, want, scores):
    """Each row where the tokens differ must be a near-tie of the
    reference's perturbed scores; print it."""
    for r in np.flatnonzero(got != want):
        top2 = np.sort(scores[r])[-2:]
        gap = float(top2[1] - top2[0])
        print(f"{name}: row {r} token {got[r]} != {want[r]}, top-two gap {gap:.3g}")
        assert gap <= NEAR_TIE * max(1.0, abs(float(top2[1]))), (name, r, gap)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.3])
def test_static_engine_draw_equals_jax(temperature, dtype):
    """``categorical(split(key)[1], logits / T)`` over an (8, V) batch,
    jitted as in the reference's static engine, against the port's draw
    with the key split in place."""
    tdt, jdt = dtype
    rng = np.random.default_rng(int(temperature * 10))
    lg = (rng.standard_normal((8, 4097)) * 3).astype(np.float32)
    jl = jnp.asarray(lg).astype(jdt)
    tl = torch.from_numpy(lg).to(tdt)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def draw(key, logits):
        key, sub = jax.random.split(key)
        scaled = logits / temperature
        return (jax.random.categorical(sub, scaled, axis=-1), key,
                jax.random.gumbel(sub, scaled.shape, scaled.dtype) + scaled)

    want, want_key, scores = draw(key, jl)
    tk = sampling.prng_key(11)
    got = sample(tl, temperature, key=tk, split_key=True).numpy()
    assert got.dtype == np.int32
    assert (_u32(tk) == np.asarray(want_key)).all()
    _print_ties("static", got, np.asarray(want), _f32(scores))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("top_k,temperature", [(0, 1.0), (20, 0.9), (1, 1.2), (300, 0.5)])
def test_continuous_engine_draw_equals_jax(top_k, temperature, dtype):
    """The reference's ``sample_rows`` (float32 cast, temperature, top-k
    mask, ``vmap(categorical)`` under ``fold_in(PRNGKey(seed), idx)``)
    against the port's draw from seeds and indices."""
    rng = np.random.default_rng(top_k)
    r, v = 8, 2003
    lg = (rng.standard_normal((r, v)) * 2).astype(np.float32)
    tl = torch.from_numpy(lg).to(dtype)
    jl = jnp.asarray(tl.float().numpy())   # the logits the reference casts
    seeds = rng.integers(0, 2**32, r, dtype=np.uint32)
    idx = rng.integers(0, 64, r).astype(np.int32)
    temp = float(max(temperature, 1e-6))

    @jax.jit
    def rows(logits, seeds, idx):
        lg = logits.astype(jnp.float32) / temp
        if top_k > 0:
            kth = jax.lax.top_k(lg, min(top_k, lg.shape[-1]))[0][..., -1:]
            lg = jnp.where(lg < kth, -jnp.inf, lg)
        keys = jax.vmap(lambda s, i: jax.random.fold_in(jax.random.PRNGKey(s), i))(
            seeds, idx)
        noise = jax.vmap(lambda k: jax.random.gumbel(k, lg.shape[-1:]))(keys)
        return jax.vmap(jax.random.categorical)(keys, lg), noise + lg, lg

    want, scores, scaled = rows(jl, jnp.asarray(seeds), jnp.asarray(idx))
    got = sample(tl, temperature, seeds=torch.from_numpy(seeds.view(np.int32)),
                 index=torch.from_numpy(idx), top_k=top_k, dtype=torch.float32)
    _print_ties("continuous", got.numpy(), np.asarray(want), _f32(scores))
    if top_k:
        # the threshold the kernel gets is the reference's k-th value
        kth = S.top_k_threshold(tl, top_k, S.inv_temperature(temp, torch.float32),
                                torch.float32)
        want_kth = np.sort(np.asarray(scaled), axis=-1)[:, -min(top_k, v)]
        assert (kth.numpy() == want_kth).all()
        masked = S.top_k_mask(torch.from_numpy(np.asarray(scaled).copy()), top_k)
        assert (torch.isfinite(masked).sum(-1) >= min(top_k, v)).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_categorical_with_one_key_and_with_per_row_keys(dtype):
    tdt, jdt = dtype
    rng = np.random.default_rng(3)
    lg = (rng.standard_normal((5, 777)) * 2).astype(np.float32)
    jl, tl = jnp.asarray(lg).astype(jdt), torch.from_numpy(lg).to(tdt)
    key = jax.random.PRNGKey(2)
    want = np.asarray(jax.random.categorical(key, jl, axis=-1))
    got = sampling.categorical(sampling.prng_key(2), tl).numpy()
    scores = _f32(jax.random.gumbel(key, jl.shape, jdt) + jl)
    _print_ties("one key", got, want, scores)
    keys = jax.random.split(key, 5)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, jl))
    tkeys = torch.from_numpy(np.array(keys).view(np.int32))
    got = sampling.categorical(tkeys, tl).numpy()
    scores = _f32(jax.vmap(lambda k, l: jax.random.gumbel(k, l.shape, jdt) + l)(keys, jl))
    _print_ties("per-row keys", got, want, scores)
    # the op's per-row form is the same draw
    assert (sample(tl, 1.0, key=tkeys).numpy() == got).all()


def test_sample_op_checks_and_the_kernel_refuses_the_cpu():
    lg = torch.zeros((2, 10))
    with pytest.raises(ValueError, match="CUDA"):
        sample_cuda(lg, 1.0, torch.float32, keys=sampling.prng_key(0))
    with pytest.raises(ValueError, match="unsupported device"):
        sample(lg.to("meta"), 1.0, key=sampling.prng_key(0))
    with pytest.raises(ValueError, match="needs keys"):
        S.sample_ref(lg, 1.0, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sample(lg.double(), 1.0, key=sampling.prng_key(0))
    # an all-masked row and an all -inf row give the first index, as argmax
    lg[1] = float("-inf")
    assert sample(lg, 1.0, key=sampling.prng_key(0)).tolist()[1] == 0
    assert parts_for(8, 64000) * 8 <= 528 and parts_for(1, 100) == 1
    assert parts_for(64, 64000) >= 1


# ---------------------------------------------------------------------------
# the engines against the reference's
# ---------------------------------------------------------------------------

_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        r_cfg = dataclasses.replace(r_get_config(arch).smoke(), dtype="float32")
        t_cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        params, _ = r_build_model(r_cfg).init(jax.random.PRNGKey(4))
        named = {n: np.asarray(a) for n, a in _flatten_with_names(params)}
        _WEIGHTS[arch] = (r_cfg, t_cfg, params,
                          params_from_reference(t_cfg, named, device="cpu"))
    return _WEIGHTS[arch]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.mark.parametrize("arch,decode", [("yi-6b", "eager"), ("yi-6b", "static"),
                                         ("mamba2-1.3b", "eager")])
def test_static_engine_samples_the_reference_tokens(arch, decode):
    r_cfg, t_cfg, params, model = _weights(arch)
    kw = dict(max_new_tokens=10, max_len=96, greedy=False, temperature=0.8, seed=5,
              sync_every=4)
    want = REngine(r_cfg, params, RServeConfig(**kw))
    got = Engine(t_cfg, model, ServeConfig(**kw), device="cpu", decode=decode)
    for prompts in (PROMPTS, PROMPTS[:2]):
        assert ([r.token_ids for r in got.generate(prompts)]
                == [r.token_ids for r in want.generate(prompts)])


@pytest.mark.parametrize("decode", ["eager", "static"])
def test_continuous_engine_samples_the_reference_tokens(decode):
    r_cfg, t_cfg, params, model = _weights("yi-6b")
    kw = dict(max_new_tokens=9, max_len=64, greedy=False, temperature=0.9, top_k=20)
    spec = dict(n_blocks=33, block_size=8, max_slots=3, max_blocks_per_seq=8)
    want = RContinuousEngine(r_cfg, params, RK.PagedCacheSpec(**spec), RServeConfig(**kw))
    got = ContinuousEngine(t_cfg, model, TK.PagedCacheSpec(**spec), ServeConfig(**kw),
                           device="cpu", decode=decode)
    try:
        budgets = [3, 9, 5, 7, 2]
        texts = PROMPTS + ["N#N"]
        out = []
        for eng in (want, got):
            futs = [eng.submit(t, n, lead=False, seed=100 + i)
                    for i, (t, n) in enumerate(zip(texts, budgets))]
            eng._maybe_lead()
            out.append([f.result(timeout=300).token_ids for f in futs])
        assert out[1] == out[0]
        # without explicit seeds: scfg.seed + the submission ordinal, both sides
        assert ([r.token_ids for r in got.generate(PROMPTS[:2])]
                == [r.token_ids for r in want.generate(PROMPTS[:2])])
        got.check()
    finally:
        want.close()
        got.close()
