"""The port's copies of the paper's own modules against the reference's, on
the CPU: Algorithm 1's brute-force baseline (``core/baseline.py``), §VI's
collision scan (``core/collisions.py``) and the ``hash_mix`` helpers
``hash_mix_u64`` / ``digest_ids``.

One corpus serves both packages (the generators write the same bytes).
Host results must be equal, and digests equal bit for bit; the reference's
``hash_mix`` runs through its plain reference on the CPU, as its own tests
run it.  Last, the funnel's two new phases run end to end.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.sdfgen import CorpusSpec as RSpec
from repro.kernels.hash_mix.ops import digest_ids as r_digest_ids
from repro.kernels.hash_mix.ops import hash_mix_u64 as r_hash_mix_u64
from repro_torch.kernels.hash_mix.ops import digest_ids, hash_mix_u64
from repro_torch.kernels.hash_mix.ref import to_u32
from repro_torch.launch import funnel

# 4 x 1,000 records: at 17-bit keys E[colliding pairs] = n^2 / 2^18 ≈ 61
SPEC = dict(n_files=4, records_per_file=1000)
KEY_BITS = (12, 17)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("paper") / "corpus"
    R.generate_corpus(root, RSpec(**SPEC))
    return R.RecordStore(root), T.RecordStore(root), RSpec(**SPEC)


def _fields(res, skip=("seconds",)):
    return {k: v for k, v in dataclasses.asdict(res).items() if k not in skip}


# ---------------------------------------------------------------------------
# Algorithm 1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("membership", ["list", "set"])
@pytest.mark.parametrize("max_files", [None, 1])
def test_naive_scan_equals_reference(corpus, membership, max_files):
    r_store, t_store, spec = corpus
    targets = R.db_id_list(spec, "chembl", extra_outside=5)[:40]
    want = R.naive_scan(r_store, targets, membership, max_files=max_files)
    got = T.naive_scan(t_store, targets, membership, max_files=max_files)
    assert _fields(got) == _fields(want)
    assert got.records_scanned > 0


def test_naive_scan_equals_extraction(corpus):
    _, t_store, spec = corpus
    targets = R.db_id_list(spec, "emolecules")[:25]
    naive = T.naive_scan(t_store, targets, membership="set")
    idx = T.build_index(t_store)
    res = T.extract(t_store, idx, targets, device="cpu")
    assert set(naive.records) == set(res.records)
    for k, text in naive.records.items():
        assert text.strip() == res.records[k].strip()


def test_naive_scan_rejects_unknown_membership(corpus):
    with pytest.raises(ValueError):
        T.naive_scan(corpus[1], [], membership="dict")


def test_measure_scan_throughput_counts_equal_reference(corpus):
    r_store, t_store, _ = corpus
    want = R.measure_scan_throughput(r_store, n_files=3)
    got = T.measure_scan_throughput(t_store, n_files=3)
    key = lambda s: (s.file, s.file_bytes, s.records)  # noqa: E731
    assert [key(s) for s in got] == [key(s) for s in want]
    assert all(s.records_per_second > 0 for s in got)


@pytest.mark.parametrize("membership", ["list", "set"])
@pytest.mark.parametrize("args", [(477_123, 354, 500_000, 3.2e6),
                                  (10, 3, 7, 0.0), (1, 1, 176_929_690, 6.5e4)])
def test_estimate_runtime_equals_reference(membership, args):
    assert (T.estimate_runtime(*args, membership=membership)
            == R.estimate_runtime(*args, membership=membership))


# ---------------------------------------------------------------------------
# §VI collisions
# ---------------------------------------------------------------------------

def _pairs(t_store, bits):
    pairs = []
    for path in t_store.files():
        for _off, text in T.iter_records(path):
            fid = T.extract_property(text, "PUBCHEM_IUPAC_INCHI")
            pairs.append((T.hashed_key(fid, bits), fid))
    return pairs


@pytest.mark.parametrize("bits", KEY_BITS)
def test_scan_corpus_equals_reference_and_sorted_path(corpus, bits):
    r_store, t_store, _ = corpus
    want = R.scan_corpus(r_store, key_bits=bits)
    got = T.scan_corpus(t_store, key_bits=bits)
    assert _fields(got) == _fields(want)
    assert got.n_colliding_keys > 0 and got.n_records == 4000
    assert got.empirical_rate == want.empirical_rate
    pairs = _pairs(t_store, bits)
    keys, ids = [k for k, _ in pairs], [i for _, i in pairs]
    assert T.scan_pairs_sorted(keys, ids) == got.colliding
    assert R.scan_pairs_sorted(keys, ids) == got.colliding
    assert T.collisions_from_pairs(pairs) == got.colliding


def test_scan_pairs_sorted_and_from_pairs_equal_reference():
    rng = np.random.default_rng(3)
    keys = [f"K{int(k)}" for k in rng.integers(0, 60, 500)]
    ids = [f"InChI=1S/x{int(i)}" for i in rng.integers(0, 200, 500)]
    pairs = list(zip(keys, ids)) + [("dup", "same"), ("dup", "same")]
    assert T.collisions_from_pairs(pairs) == R.collisions_from_pairs(pairs)
    assert "dup" not in T.collisions_from_pairs(pairs)  # duplicates are not collisions
    assert T.scan_pairs_sorted(keys, ids) == R.scan_pairs_sorted(keys, ids)
    assert T.scan_pairs_sorted([], []) == {}
    with pytest.raises(ValueError):
        T.scan_pairs_sorted(["a"], [])


@pytest.mark.parametrize("n,bits", [(0, 17), (1500, 16), (100_000, 17),
                                    (176_929_690, 50)])
def test_birthday_expectation_equals_reference(n, bits):
    assert T.birthday_expectation(n, bits) == R.birthday_expectation(n, bits)


# ---------------------------------------------------------------------------
# hash_mix helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,w,seed", [(1, 1, 0), (300, 8, 7), (64, 33, 2**32 - 1)])
def test_hash_mix_u64_matches_reference_bit_for_bit(n, w, seed):
    x = np.random.default_rng(n + w).integers(0, 2**32, (n, w), dtype=np.uint64)
    x = x.astype(np.uint32)
    want = np.asarray(r_hash_mix_u64(jnp.asarray(x), seed=seed))
    got = hash_mix_u64(to_u32(torch.from_numpy(x.astype(np.int64))), seed=seed)
    assert got.shape == (n, 2) and got.dtype == torch.uint32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 11])
def test_digest_ids_matches_reference_bit_for_bit(corpus, seed):
    _, _, spec = corpus
    ids = R.db_id_list(spec, "chembl")[:50] + ["", "é" * 70, "InChI=1S/short"]
    want = r_digest_ids(ids, seed=seed)
    got = digest_ids(ids, seed=seed, device="cpu")
    assert got.dtype == np.uint32 and got.shape == (len(ids), 2)
    assert np.array_equal(got, want)


def test_digest_ids_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        digest_ids(["InChI=1S/x"])


def test_core_exports_the_paper_modules():
    for name in ("BaselineResult", "naive_scan", "estimate_runtime",
                 "measure_scan_throughput", "CollisionReport", "scan_corpus",
                 "scan_pairs_sorted", "collisions_from_pairs",
                 "birthday_expectation"):
        assert hasattr(T, name), name


# ---------------------------------------------------------------------------
# the funnel's two phases
# ---------------------------------------------------------------------------

def test_funnel_collision_scan_and_baseline_phases():
    lines = []
    summary = funnel.run_funnel(800, seed=0, device="cpu", workers=1,
                                log=lines.append)
    col, base = summary["collisions"], summary["baseline"]
    assert col["key_bits"] == summary["hashed_key_bits"] == 10
    assert col["records"] == 800 and col["colliding_keys"] > 0
    assert col["mismatches"] == summary["hashed_mismatches"]
    assert col["collision_mismatches"] <= col["affected_records"] - col["colliding_keys"]
    assert col["birthday_expectation"] == R.birthday_expectation(800, 10)
    assert base["targets_checked"] == funnel.BASELINE_TARGETS
    assert base["projected_ops"] == float(funnel.PAPER_TARGETS) * funnel.PUBCHEM_RECORDS
    assert base["ratio"] > 1
    assert any(line.startswith("§VI scan") for line in lines)
    assert any(line.startswith("Algorithm 1") for line in lines)
