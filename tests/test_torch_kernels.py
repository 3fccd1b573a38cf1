"""The port's kernels against the reference package's, on the CPU.

The port's plain PyTorch versions (what a wrapper runs for a CPU tensor,
and what the CUDA kernels are held to on the card) must be bit-exact
against ``repro``'s pure-jnp references and against the Pallas kernels in
interpret mode.  Inputs are made from seeds with numpy and handed to both
packages.  The CUDA kernels themselves run only on the card: see
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from repro.kernels.hash_mix.kernel import hash_mix_pallas
from repro.kernels.hash_mix.ref import hash_mix_ref as jax_hash_mix_ref
from repro.kernels.sorted_probe.ops import sorted_probe_pallas
from repro.kernels.sorted_probe.ref import sorted_probe_ref as jax_probe_ref
from repro_torch.device import resolve_device
from repro_torch.kernels import hash_mix, sorted_probe
from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
from repro_torch.kernels.hash_mix.ref import from_u32, hash_mix_ref, to_u32
from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
from repro_torch.kernels.sorted_probe.ref import pairs_to_key, sorted_probe_ref

# the shapes and cases of tests/test_kernels.py
HASH_SHAPES = [(1, 8), (37, 16), (256, 8), (1000, 24), (4096, 64), (513, 8), (8, 40)]
PROBE_CASES = [
    (100, 50, 512, None),
    (5000, 1000, 512, None),
    (10000, 4096, 2048, None),
    (300, 7, 128, None),
    (65536, 4096, 2048, None),
    (2000, 1024, 2048, 8),     # forces the Pallas overflow fallback
    (2000, 512, 256, 16),
]
SEEDS = [0, 1, 0x9E3779B1, 2**32 - 1]


def _port_hash(x: np.ndarray, seed: int = 0) -> np.ndarray:
    out = hash_mix(torch.from_numpy(x), seed=seed)
    assert out.dtype == torch.uint32 and out.shape == (x.shape[0], 4)
    return out.numpy()


# ---------------------------------------------------------------------------
# hash_mix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w", HASH_SHAPES)
def test_hash_mix_plain_matches_ref_and_pallas(n, w):
    rng = np.random.default_rng(n * 1000 + w)
    x = rng.integers(0, 2**32, size=(n, w), dtype=np.uint32)
    ours = _port_hash(x)
    np.testing.assert_array_equal(ours, np.asarray(jax_hash_mix_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        ours, np.asarray(hash_mix_pallas(jnp.asarray(x), interpret=True))
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_mix_plain_matches_ref_across_seeds(seed):
    rng = np.random.default_rng(seed % 1000)
    x = rng.integers(0, 2**32, size=(300, 16), dtype=np.uint32)
    np.testing.assert_array_equal(
        _port_hash(x, seed), np.asarray(jax_hash_mix_ref(jnp.asarray(x), seed=seed))
    )


def test_hash_mix_extreme_lanes_match_ref():
    """All-zero and all-ones lanes stress the wraparound arithmetic."""
    x = np.array([[0] * 8, [0xFFFFFFFF] * 8, [0x80000000, 1] * 4], dtype=np.uint32)
    np.testing.assert_array_equal(
        _port_hash(x, 7), np.asarray(jax_hash_mix_ref(jnp.asarray(x), seed=7))
    )


def test_hash_mix_row_locality():
    """A row's digest depends on that row only: permuting rows permutes
    digests, and hashing a row alone gives the same digest."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 2**32, size=(64, 24), dtype=np.uint32)
    full = _port_hash(x)
    perm = rng.permutation(64)
    np.testing.assert_array_equal(_port_hash(x[perm]), full[perm])
    for i in (0, 17, 63):
        np.testing.assert_array_equal(_port_hash(x[i:i + 1]), full[i:i + 1])


def test_hash_mix_rejects_bad_input():
    with pytest.raises(TypeError):
        hash_mix_ref(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        hash_mix_ref(torch.zeros(8, dtype=torch.int32).view(torch.uint32))


def test_u32_round_trip():
    v = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    u = to_u32(v)
    assert u.dtype == torch.uint32
    assert torch.equal(from_u32(u), v)
    np.testing.assert_array_equal(
        u.numpy(), np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    )


# ---------------------------------------------------------------------------
# sorted_probe
# ---------------------------------------------------------------------------

def _mk_table_queries(rng, m, q, hit_frac=0.5, bits=32):
    """Sorted (M, 2) uint32 table (unique when ``bits == 32``; duplicate
    runs when the lo word is narrowed) and (Q, 2) queries, half hits."""
    t = rng.integers(0, 2**32, size=(m, 2), dtype=np.uint32)
    if bits < 32:
        t[:, 0] = 0
        t[:, 1] &= np.uint32((1 << bits) - 1)
    t = t.view([("hi", np.uint32), ("lo", np.uint32)]).ravel()
    t = (np.unique(t) if bits == 32 else np.sort(t, order=["hi", "lo"]))
    t = t.view(np.uint32).reshape(-1, 2)
    nhit = int(q * hit_frac)
    misses = rng.integers(0, 2**32, size=(q - nhit, 2), dtype=np.uint32)
    if bits < 32:
        misses[:, 0] = 0
        misses[:, 1] &= np.uint32((1 << bits) - 1)
    qs = np.vstack([t[rng.integers(0, len(t), nhit)], misses])
    rng.shuffle(qs)
    return qs, t


def _numpy_truth(qs, t):
    tv = t[:, 0].astype(np.uint64) << np.uint64(32) | t[:, 1].astype(np.uint64)
    qv = qs[:, 0].astype(np.uint64) << np.uint64(32) | qs[:, 1].astype(np.uint64)
    pos = np.searchsorted(tv, qv, side="left")
    found = (pos < len(tv)) & (tv[np.minimum(pos, len(tv) - 1)] == qv)
    return found, pos.astype(np.int32)


def _port_probe(qs, t):
    f, p = sorted_probe(torch.from_numpy(qs), torch.from_numpy(t))
    assert f.dtype == torch.bool and p.dtype == torch.int32
    return f.numpy(), p.numpy()


@pytest.mark.parametrize("m,q,bt,qmax", PROBE_CASES)
def test_sorted_probe_plain_matches_ref_and_pallas(m, q, bt, qmax):
    rng = np.random.default_rng(m + q)
    qs, t = _mk_table_queries(rng, m, q)
    f, p = _port_probe(qs, t)
    f_ref, p_ref = jax_probe_ref(jnp.asarray(qs), jnp.asarray(t))
    np.testing.assert_array_equal(f, np.asarray(f_ref))
    np.testing.assert_array_equal(p, np.asarray(p_ref))
    f_pal, p_pal = sorted_probe_pallas(
        jnp.asarray(qs), jnp.asarray(t), table_block=bt, qmax=qmax, interpret=True
    )
    np.testing.assert_array_equal(f, np.asarray(f_pal))
    np.testing.assert_array_equal(p, np.asarray(p_pal))


@pytest.mark.parametrize("m,q,bits", [(3000, 500, 10), (20000, 2000, 12), (257, 64, 4)])
def test_sorted_probe_duplicate_runs_match_ref(m, q, bits):
    """Tables with duplicate runs: the plain version returns the global
    lower bound (the head of the run), held to ``sorted_probe_ref`` only —
    the Pallas path returns within-block positions on such tables."""
    rng = np.random.default_rng(m * bits)
    qs, t = _mk_table_queries(rng, m, q, bits=bits)
    assert len(np.unique(t, axis=0)) < len(t)  # runs were seeded
    f, p = _port_probe(qs, t)
    f_ref, p_ref = jax_probe_ref(jnp.asarray(qs), jnp.asarray(t))
    np.testing.assert_array_equal(f, np.asarray(f_ref))
    np.testing.assert_array_equal(p, np.asarray(p_ref))
    f_np, p_np = _numpy_truth(qs, t)
    np.testing.assert_array_equal(f, f_np)
    np.testing.assert_array_equal(p, p_np)


def test_sorted_probe_edges():
    t = np.array([[0, 0], [0, 5], [1, 0], [0xFFFFFFFF, 0xFFFFFFFF]], dtype=np.uint32)
    qs = np.array([[0, 0], [0, 1], [0, 6], [0xFFFFFFFF, 0xFFFFFFFF],
                   [0x80000000, 0], [0xFFFFFFFF, 0xFFFFFFFE]], dtype=np.uint32)
    f, p = _port_probe(qs, t)
    f_np, p_np = _numpy_truth(qs, t)
    np.testing.assert_array_equal(f, f_np)
    np.testing.assert_array_equal(p, p_np)
    f0, p0 = _port_probe(qs, np.zeros((0, 2), np.uint32))
    assert not f0.any() and not p0.any()


def test_pairs_to_key_preserves_unsigned_order():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, size=(500, 2), dtype=np.uint32)
    keys = pairs_to_key(torch.from_numpy(x)).numpy()
    u = x[:, 0].astype(np.uint64) << np.uint64(32) | x[:, 1].astype(np.uint64)
    np.testing.assert_array_equal(np.argsort(keys, kind="stable"),
                                  np.argsort(u, kind="stable"))


@settings(max_examples=25, deadline=None)
@given(
    m=st.integers(1, 400),
    q=st.integers(1, 200),
    bits=st.sampled_from([3, 8, 32]),
    seed=st.integers(0, 2**31 - 1),
)
def test_sorted_probe_property(m, q, bits, seed):
    rng = np.random.default_rng(seed)
    qs, t = _mk_table_queries(rng, m, q, hit_frac=0.7, bits=bits)
    f, p = _port_probe(qs, t)
    f_np, p_np = _numpy_truth(qs, t)
    np.testing.assert_array_equal(f, f_np)
    np.testing.assert_array_equal(p, p_np)


# ---------------------------------------------------------------------------
# dispatch and device policy
# ---------------------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_version_without_launching():
    h0, p0 = hash_mix_cuda.launches, sorted_probe_cuda.launches
    x = torch.from_numpy(np.arange(64, dtype=np.uint32).reshape(8, 8))
    assert torch.equal(hash_mix(x, seed=3), hash_mix_ref(x, seed=3))
    t = torch.from_numpy(np.arange(20, dtype=np.uint32).reshape(10, 2))
    f, p = sorted_probe(t[:4], t)
    f2, p2 = sorted_probe_ref(t[:4], t)
    assert torch.equal(f, f2) and torch.equal(p, p2) and bool(f.all())
    assert (hash_mix_cuda.launches, sorted_probe_cuda.launches) == (h0, p0)


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((4, 8), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        hash_mix_cuda(x)
    t = torch.zeros((4, 2), dtype=torch.int32).view(torch.uint32)
    with pytest.raises(ValueError):
        sorted_probe_cuda(t, t)


def test_asking_for_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_launch_counter_is_exact_across_threads():
    """``count_launch`` is a read-modify-write under a lock: with more
    threads than cores and a tiny switch interval, no increment is lost."""
    import sys
    import threading

    from repro_torch.kernels.build import count_launch

    def wrapper():  # stands in for a kernel wrapper
        pass

    wrapper.launches = 0
    n_threads, per_thread = 32, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(
                target=lambda: [count_launch(wrapper) for _ in range(per_thread)])
            for _ in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * per_thread
