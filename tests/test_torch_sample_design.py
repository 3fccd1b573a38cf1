"""The ``sample`` kernel's one-launch design, replayed on the CPU.

``csrc/sample.cu`` cuts each row into the chunks ``kernel.geometry`` gives;
for a top-k draw each block lists its chunk's k largest scaled logits (as
order-preserving keys), the ones above its k-th key with their scores and
the rest by key alone, and keeps the first maximum score among all its
logits equal to its k-th key (its tie entry); the last block of the row to
arrive takes the k-th largest key of the union of the lists as the
threshold and the first maximum over the list entries at or above it and
the tie entries of the blocks whose k-th key equals it.  :func:`chunk_and_fold`
below does the same in numpy.  It is held, bit for bit, to the plain
version ``sample_ref`` (``torch.topk``'s threshold, the whole row's
argmax) on rows that break a careless fold (``torch_sample_rows``: the k-th
value repeated across chunk boundaries, ``-inf`` logits, fewer than k
finite logits), at k = 1, 40 (the engines'), the cap, the cap + 1 and
k >= V, at every chunk count ``parts_for`` gives the repo's vocabularies at
R = 1 and R = 8; and, on those rows, ``sample_ref`` and the model are held
to the reference's ``sample_rows`` logic in ``jax.random`` (a differing
token only at a near-tie of the reference's scores).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels.sample import ref as S
from repro_torch.kernels.sample.kernel import geometry
from repro_torch.kernels.sample.ops import sample
from torch_sample_rows import GEOMETRIES, KS, k_id, kind_offset, special_rows

INT_MAX = 2**31 - 1
KEY_NAN = 0xFFFFFFFF
NO_KTH = 0
NEAR_TIE = 1e-5
TEMPERATURE = 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def order_keys(lg: np.ndarray) -> np.ndarray:
    """The kernel's ``order_key`` of float32 values, as int64: -0 as +0,
    every NaN above +inf."""
    b = lg.astype(np.float32).view(np.uint32).astype(np.int64)
    b = np.where(b == 0x80000000, 0, b)
    key = np.where(b & 0x80000000, ~b & 0xFFFFFFFF, b | 0x80000000)
    return np.where(np.isnan(lg), KEY_NAN, key)


def first_max(scores: np.ndarray, idx: np.ndarray) -> int:
    """The first maximum of (score, index) pairs: NaN above all, ties to
    the smaller index."""
    nan = np.isnan(scores)
    if nan.any():
        return int(idx[nan].min())
    return int(idx[scores == scores.max()].min())


def kth_largest(keys: np.ndarray, k: int) -> int:
    return int(np.sort(keys)[::-1][k - 1])


def chunk_and_fold(scores: np.ndarray, scaled: np.ndarray, k: int, parts: int,
                   chunk: int) -> np.ndarray:
    """The kernel's top-k draw over ``(R, V)`` unmasked ``scores`` and
    ``scaled`` logits: per chunk a k-list and a tie entry, then the fold."""
    r, v = scores.shape
    keys = order_keys(scaled)
    out = np.empty(r, np.int32)
    for row in range(r):
        if not 0 < k < v:   # k >= V masks nothing
            out[row] = first_max(scores[row], np.arange(v))
            continue
        lk, ls, li, tk, ts, ti = [], [], [], [], [], []
        for p in range(parts):
            b, e = p * chunk, min(v, (p + 1) * chunk)
            key, sc, idx = keys[row, b:e], scores[row, b:e], np.arange(b, e)
            if e - b > k:
                t_b = kth_largest(key, k)
                up = key > t_b
                fill = k - int(up.sum())
                lk += [key[up], np.full(fill, t_b)]
                ls += [sc[up], np.full(fill, -np.inf)]
                li += [idx[up], np.full(fill, INT_MAX)]
                eq = key == t_b
                best = first_max(sc[eq], idx[eq])
                tk.append(t_b)
                ts.append(scores[row, best])
                ti.append(best)
            else:   # a short chunk lists all, pads to k, keeps no tie entry
                pad = k - (e - b)
                lk += [key, np.full(pad, NO_KTH)]
                ls += [sc, np.full(pad, -np.inf)]
                li += [idx, np.full(pad, INT_MAX)]
                tk.append(NO_KTH)
                ts.append(-np.inf)
                ti.append(INT_MAX)
        lk, ls, li = (np.concatenate(a) for a in (lk, ls, li))
        assert lk.size == parts * k
        thr = kth_largest(lk, k)
        tk, ts, ti = np.array(tk), np.array(ts, np.float32), np.array(ti)
        assert (tk <= thr).all()   # every chunk's k-th key is at most the row's
        keep_l = (lk >= thr) | (thr == KEY_NAN)
        keep_t = (tk >= thr) | (thr == KEY_NAN)
        out[row] = first_max(np.concatenate([ls[keep_l].astype(np.float32), ts[keep_t]]),
                             np.concatenate([li[keep_l], ti[keep_t]]))
    return out


def _draw(r, v, k, dtype, seed, offset=0):
    """The rows, the lanes' seeds and indices, and ``sample_ref``'s tokens
    and unmasked scores (``dtype`` the logits' and the draw's)."""
    parts, chunk = geometry(r, v)
    kk = v if k is None else k
    lg = torch.from_numpy(special_rows(r, v, kk, chunk, seed, offset)).to(dtype)
    rng = np.random.default_rng(seed + 1)
    seeds = torch.from_numpy(rng.integers(0, 2**32, r, dtype=np.uint32).view(np.int32))
    index = torch.from_numpy(rng.integers(0, 64, r).astype(np.int32))
    inv_t = S.inv_temperature(TEMPERATURE, dtype)
    kth = S.top_k_threshold(lg, kk, inv_t, dtype)
    want = S.sample_ref(lg, inv_t, dtype, seeds=seeds, index=index, kth=kth)
    scores = S.sample_scores(lg, inv_t, dtype, seeds=seeds, index=index)
    scaled = S.scale_logits(lg, inv_t, dtype)
    return lg, seeds, index, want.numpy(), scores.numpy(), scaled.numpy(), kk, parts, chunk


@pytest.mark.parametrize("k", KS, ids=k_id)
@pytest.mark.parametrize("r,v", GEOMETRIES)
def test_chunk_and_fold_equals_sample_ref(r, v, k):
    """The model's tokens are the plain version's, bit for bit, at every
    chunk count of the repo's vocabularies; the ops entry point's CPU
    route is the plain version."""
    lg, seeds, index, want, scores, scaled, kk, parts, chunk = _draw(
        r, v, k, torch.float32, seed=v + r, offset=kind_offset(k))
    got = chunk_and_fold(scores, scaled, kk, parts, chunk)
    np.testing.assert_array_equal(got, want)
    op = sample(lg, TEMPERATURE, seeds=seeds, index=index, top_k=kk, dtype=torch.float32)
    np.testing.assert_array_equal(op.numpy(), want)


@pytest.mark.parametrize("k", KS, ids=k_id)
def test_chunk_and_fold_in_bfloat16(k):
    """A bfloat16 draw rounds the scaled logits, so that more of them are
    equal at the threshold: the model is still the plain version."""
    lg, seeds, index, want, scores, scaled, kk, parts, chunk = _draw(
        8, 9000, k, torch.bfloat16, seed=3)
    np.testing.assert_array_equal(chunk_and_fold(scores, scaled, kk, parts, chunk), want)


def _jax_rows(lg: np.ndarray, seeds: np.ndarray, idx: np.ndarray, k: int):
    """The reference's ``sample_rows`` (``src/repro/serve/scheduler.py``):
    float32, temperature, ``lax.top_k``'s mask, ``vmap(categorical)`` under
    ``fold_in(PRNGKey(seed), idx)``; its tokens and perturbed scores."""
    @jax.jit
    def rows(logits, seeds, idx):
        x = logits.astype(jnp.float32) / TEMPERATURE
        kth = jax.lax.top_k(x, min(k, x.shape[-1]))[0][..., -1:]
        x = jnp.where(x < kth, -jnp.inf, x)
        keys = jax.vmap(lambda s, i: jax.random.fold_in(jax.random.PRNGKey(s), i))(
            seeds, idx)
        noise = jax.vmap(lambda key: jax.random.gumbel(key, x.shape[-1:]))(keys)
        return jax.vmap(jax.random.categorical)(keys, x), noise + x

    want, scores = rows(jnp.asarray(lg), jnp.asarray(seeds), jnp.asarray(idx))
    return np.asarray(want), np.asarray(scores)


@pytest.mark.parametrize("k", KS, ids=k_id)
@pytest.mark.parametrize("r,v", [(8, 4097), (1, 64000)])
def test_special_rows_equal_jax(r, v, k):
    """On the rows that break a careless fold, the plain version and the
    chunk-and-fold model draw the reference's tokens (a differing token only
    where the reference's top two scores lie within ``NEAR_TIE``)."""
    lg, seeds, index, want, scores, scaled, kk, parts, chunk = _draw(
        r, v, k, torch.float32, seed=11 + v, offset=kind_offset(k) + 1)
    ref, ref_scores = _jax_rows(lg.numpy(), seeds.numpy().view(np.uint32),
                                index.numpy(), kk)
    model = chunk_and_fold(scores, scaled, kk, parts, chunk)
    np.testing.assert_array_equal(model, want)
    for row in np.flatnonzero(want != ref):
        finite = np.sort(ref_scores[row][np.isfinite(ref_scores[row])])[-2:]
        assert finite.size == 2, (row, want[row], ref[row])
        gap = float(finite[-1] - finite[0])
        print(f"row {row}: token {want[row]} != reference {ref[row]}, gap {gap:.3g}")
        assert gap <= NEAR_TIE * max(1.0, abs(float(finite[-1])))


def test_rows_are_what_they_say():
    """The special rows at k = 40 over yi-6b's chunks: the tie row has more
    than k logits equal to its k-th largest, at the ends of chunks; the
    ``-inf`` rows start with one; the sparse row has fewer than k finite."""
    parts, chunk = geometry(8, 64000)
    lg = special_rows(8, 64000, 40, chunk, seed=5)
    kth = np.sort(lg[0])[::-1][39]
    assert kth == 0.5 and (lg[0] == kth).sum() > 40
    assert lg[0][chunk - 1] == kth and lg[0][chunk] == kth
    assert np.isneginf(lg[1][0]) and np.isneginf(lg[5][0])
    assert np.isfinite(lg[2]).sum() < 40 and np.isfinite(lg[6]).sum() < 40
    assert len(np.unique(lg[3])) < 200
    assert parts == 63 and chunk == 1016
