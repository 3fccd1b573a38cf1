"""The port's similarity search against the reference package's, on the CPU.

The plain ``tanimoto`` top-k against ``repro``'s ``tanimoto_topk_ref`` and
its Pallas kernel in interpret mode (tie floods, W in {1, 2, 32}, k > N,
empty inputs); ``merge_similar_topk`` against ``repro``'s; the port
store's ``similar_batch`` / ``similar_shard`` (host probe, and the device
probe, which on a CPU store runs the plain version over the store's
device tables) against ``repro``'s ``similar_batch(probe="host")`` on the
same published store, ``QueryStats`` included, with stores written by
either package and opened by the other.  Scores are compared as raw
float32 bits, rows and locations exactly.
"""

import dataclasses
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.store import merge_similar_topk as r_merge
from repro.kernels.tanimoto.ops import tanimoto_topk as r_tanimoto_topk
from repro.kernels.tanimoto.ref import tanimoto_topk_ref as r_ref
from repro_torch.core.store import merge_similar_topk as t_merge
from repro_torch.kernels.tanimoto.kernel import (
    MAX_K,
    plan,
    tanimoto_topk_cuda,
)
from repro_torch.kernels.tanimoto.ops import tanimoto_topk
from repro_torch.kernels.tanimoto.ref import row_counts, tanimoto_topk_ref

# repetitions of "ABC" share one trigram set: distinct keys, identical
# fingerprints (the reference's tie flood)
TIE_KEYS = ["ABC" * r for r in range(2, 12)]


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread is as fast, and the
    test workers beside this one keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _plane(rng, n, w, distinct):
    """``n`` rows drawn from ``distinct`` sparse fingerprints; the first is
    all zero, so zero queries meet zero rows (u == 0)."""
    base = rng.integers(0, 2**32, (max(distinct, 1), w), dtype=np.uint32)
    base &= rng.integers(0, 2**32, base.shape, dtype=np.uint32)
    base[0] = 0
    return np.ascontiguousarray(base[rng.integers(0, len(base), n)])


def _queries(rng, db, qn, w):
    n_rows = min(qn // 2, len(db))
    q = rng.integers(0, 2**32, (qn, w), dtype=np.uint32)
    if n_rows:
        q[:n_rows] = db[rng.integers(0, len(db), n_rows)]
    q[n_rows : n_rows + 1] = 0
    return q


def _port(q, db, k, **kw):
    s, i = tanimoto_topk_ref(torch.from_numpy(q), torch.from_numpy(db), k, **kw)
    return s.numpy(), i.numpy()


def _same(a, b):
    assert a[0].dtype == b[0].dtype == np.float32
    np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    np.testing.assert_array_equal(a[1], b[1])


# ---------------------------------------------------------------------------
# the plain tanimoto against the reference and its Pallas kernel
# ---------------------------------------------------------------------------

CASES = [  # (queries, rows, words, k, distinct fingerprints)
    (7, 500, 32, 8, 20),     # tie flood
    (5, 300, 1, 6, 10),      # W = 1
    (4, 257, 2, 9, 30),      # W = 2
    (6, 700, 32, 1, 700),    # k = 1
    (3, 5, 32, 12, 3),       # k > N: pads
    (2, 40, 2, 40, 4),       # k == N, all ties
]


@pytest.mark.parametrize("qn,n,w,k,distinct", CASES)
def test_plain_matches_reference_ref(qn, n, w, k, distinct):
    rng = np.random.default_rng(qn * 1000 + n + w)
    db = _plane(rng, n, w, distinct)
    q = _queries(rng, db, qn, w)
    want = r_ref(q, db, k)
    _same(_port(q, db, k), want)
    # small blocks: the running merge across many blocks gives the same
    _same(_port(q, db, k, db_chunk=64), want)


@pytest.mark.parametrize("qn,n,w,k,distinct", CASES)
def test_plain_matches_pallas_interpret(qn, n, w, k, distinct):
    rng = np.random.default_rng(qn * 1000 + n + w + 1)
    db = _plane(rng, n, w, distinct)
    q = _queries(rng, db, qn, w)
    _same(_port(q, db, k), r_tanimoto_topk(q, db, k, interpret=True))


def test_plain_fingerprint_tie_flood_rows_ascend():
    texts = ["ABCABC"] * 9 + [f"U{i:03d}" for i in range(30)]
    db, _ = T.fingerprint_batch(texts)
    q, _ = T.fingerprint_batch(["ABCABCABC", "U005"])
    got = _port(q, db, 6)
    _same(got, r_tanimoto_topk(q, db, 6, interpret=True))
    assert got[1][0].tolist() == [0, 1, 2, 3, 4, 5]


@pytest.mark.parametrize("qn,n", [(0, 50), (3, 0), (0, 0)])
def test_plain_empty_inputs(qn, n):
    rng = np.random.default_rng(5)
    q = rng.integers(0, 2**32, (qn, 2), dtype=np.uint32)
    db = rng.integers(0, 2**32, (n, 2), dtype=np.uint32)
    got = _port(q, db, 3)
    assert got[0].shape == got[1].shape == (qn, 3)
    _same(got, r_ref(q, db, 3))


def test_plain_rejects_bad_arguments():
    q = torch.zeros((2, 2), dtype=torch.uint32)
    with pytest.raises(ValueError, match="k must be"):
        tanimoto_topk_ref(q, q, 0)
    with pytest.raises(ValueError, match="width mismatch"):
        tanimoto_topk_ref(q, torch.zeros((2, 3), dtype=torch.uint32), 1)
    with pytest.raises(ValueError, match="uint32"):
        tanimoto_topk_ref(q.to(torch.int32), q, 1)


def test_row_counts_match_reference_popcount():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, (300, 7), dtype=np.uint32)
    x[0] = 0xFFFFFFFF
    want = R.popcount_u32(x).sum(axis=1, dtype=np.int32)
    got = row_counts(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_explicit_counts_give_the_same_result():
    rng = np.random.default_rng(12)
    db = _plane(rng, 200, 4, 15)
    q = _queries(rng, db, 5, 4)
    tq, tdb = torch.from_numpy(q), torch.from_numpy(db)
    a = tanimoto_topk_ref(tq, tdb, 7)
    b = tanimoto_topk_ref(tq, tdb, 7, row_counts(tq), row_counts(tdb))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ops_dispatch_cpu_to_plain_and_wrapper_refuses_cpu():
    rng = np.random.default_rng(13)
    db = torch.from_numpy(_plane(rng, 90, 2, 9))
    q = db[:3].clone()
    got = tanimoto_topk(q, db, 4)
    want = tanimoto_topk_ref(q, db, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    before = tanimoto_topk_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tanimoto_topk_cuda(q, db, 4)
    with pytest.raises(ValueError, match="unsupported devices"):
        tanimoto_topk(q.to("meta"), db.to("meta"), 4)
    assert tanimoto_topk_cuda.launches == before


@pytest.mark.parametrize("nq,n,w,k", [
    (64, 176_929_690, 32, 32), (256, 4_194_304, 32, MAX_K), (1, 6250, 32, 32),
    (512, 6250, 32, 32), (3, 100, 1, MAX_K), (100_000, 10_000, 32, MAX_K),
])
def test_launch_plan_fits_the_kernel(nq, n, w, k):
    qpw, slices, rows = plan(nq, n, w, k)
    assert qpw in (1, 4, 8) and (qpw <= nq or qpw == 1)
    assert 4 * qpw * w + 8 * 4 * qpw * k <= 232_448  # stage-1 shared memory
    assert slices % 4 == 0 and 4 <= slices <= 12_288
    assert rows == -(-n // slices)


# ---------------------------------------------------------------------------
# merge_similar_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_merge_similar_topk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    qn, k = 5, 7
    parts = []
    for _ in range(4):
        s = rng.choice(np.float32([1.0, 0.5, 0.25, 0.0]), (qn, k))
        s = -np.sort(-s, axis=1)
        s[:, k - 2 :] = np.where(rng.random((qn, 2)) < 0.5, -1.0, s[:, k - 2 :])
        f = rng.integers(0, 3, (qn, k)).astype(np.int32)
        o = rng.integers(0, 50, (qn, k)).astype(np.int64) * 64
        pad = s < 0
        parts.append((s.astype(np.float32), np.where(pad, -1, f).astype(np.int32),
                      np.where(pad, -1, o)))
    want = r_merge(parts, k)
    got = t_merge(parts, k)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the store's similarity branch against the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    spec = R.CorpusSpec(n_files=3, records_per_file=300, key_bits=16)
    root = Path(tempfile.mkdtemp()) / "corpus"
    R.generate_corpus(root, spec)
    return root


@pytest.fixture(scope="module", params=["ref", "port"])
def store_dir(request, corpus):
    """The corpus's full-id index published by either package."""
    pkg = R if request.param == "ref" else T
    idx = pkg.build_index(pkg.RecordStore(corpus), key_mode="full_id")
    sdir = Path(tempfile.mkdtemp()) / f"istore_{request.param}"
    idx.save_sharded(sdir, n_shards=8, fingerprint_bits=256)
    return sdir, sorted(idx.entries.keys())


@pytest.fixture(scope="module")
def tie_store_dir():
    """Equal-fingerprint keys spread over shards and files."""
    idx = T.ByteOffsetIndex(key_mode="full_id")
    for i, key in enumerate(TIE_KEYS):
        idx.add(key, f"f_{i % 4:02d}.sdf", 1000 + i * 64)
    for i in range(300):
        idx.add(f"FILLER/{i:05d}", f"f_{i % 4:02d}.sdf", 50_000 + i * 64)
    sdir = Path(tempfile.mkdtemp()) / "tie_store"
    idx.save_sharded(sdir, n_shards=8)
    return sdir


def _stats(st):
    return dataclasses.asdict(st.stats)


@pytest.mark.parametrize("probe", ["host", "device"])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_store_similar_batch_matches_reference(store_dir, probe, k):
    sdir, keys = store_dir
    q, _ = T.fingerprint_batch(keys[::37][:9], 256)
    ref = R.IndexStore.open(sdir)
    port = T.IndexStore.open(sdir, device="cpu")
    want = ref.similar_batch(q, k, probe="host")
    got = port.similar_batch(q, k, probe=probe)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape == (9, k)
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert _stats(port) == _stats(ref)
    assert port.stats.similar_queries == 9 and port.stats.fp_rows_scanned > 0
    # every query is a corpus key: rank 0 is its own location at 1.0
    assert (got[0][:, 0] == np.float32(1.0)).all()


def test_store_similar_shard_matches_reference(store_dir):
    sdir, keys = store_dir
    q, _ = T.fingerprint_batch(keys[5:11], 256)
    ref = R.IndexStore.open(sdir)
    port = T.IndexStore.open(sdir, device="cpu")
    qc = R.popcount_u32(q).sum(axis=1, dtype=np.int32)
    for s in range(port.n_shards):
        want = ref.similar_shard(s, q, 6, probe="host", q_counts=qc)
        for probe in ("host", "device"):
            got = port.similar_shard(s, q, 6, probe=probe, q_counts=qc)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    # each shard was scanned once by ref and twice by the port
    assert port.stats.fp_rows_scanned == 2 * ref.stats.fp_rows_scanned
    with pytest.raises(ValueError, match="out of range"):
        port.similar_shard(port.n_shards, q, 3)


def test_store_cross_shard_ties_match_reference(tie_store_dir):
    q = T.fold_fingerprint("ABCABC")[None, :]
    ref = R.IndexStore.open(tie_store_dir)
    port = T.IndexStore.open(tie_store_dir, device="cpu")
    want = ref.similar_batch(q, 6, probe="host")
    got = port.similar_batch(q, 6, probe="device")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert (got[0][0] == np.float32(1.0)).all()
    sids = T.shard_of(T.digest_u64(TIE_KEYS), port.n_shards, port.digest_bits)
    assert len(set(sids.tolist())) > 1


def test_store_similar_probe_policy_and_checks(store_dir):
    sdir, keys = store_dir
    st = T.IndexStore.open(sdir, device="cpu")
    assert st._similar_probe(None) == "host" == st._similar_probe("auto")
    with pytest.raises(ValueError, match="unknown probe"):
        st.similar_batch(np.zeros((1, st.fp_words()), np.uint32), 2, probe="tpu")
    with pytest.raises(ValueError, match="query fingerprints"):
        st.similar_batch(np.zeros((1, 3), np.uint32), 2)
    with pytest.raises(ValueError, match="k must be"):
        st.similar_batch(np.zeros((1, st.fp_words()), np.uint32), 0)
    e = st.similar_batch(np.zeros((0, st.fp_words()), np.uint32), 4)
    assert [a.shape for a in e] == [(0, 4)] * 3
    assert st.stats.similar_queries == 0


def test_store_without_fingerprints_raises(tmp_path):
    idx = T.ByteOffsetIndex(key_mode="full_id")
    for i in range(50):
        idx.add(f"K/{i}", "f.sdf", i * 10)
    idx.save_sharded(tmp_path / "s", n_shards=2, fingerprint_bits=None)
    st = T.IndexStore.open(tmp_path / "s", device="cpu")
    assert st.fingerprint_bits is None
    with pytest.raises(ValueError, match="fingerprint plane"):
        st.similar_batch(np.zeros((1, 32), np.uint32), 2)


def _host_bytes(st):
    return (sum(sh.nbytes for sh in st._shards.values())
            + sum(bf.nbytes for bf in st._blooms.values())
            + sum(int(a.nbytes) + int(b.nbytes) for a, b in st._fp_shards.values()))


def test_device_tables_upload_once_and_replicas_share_them(store_dir):
    sdir, keys = store_dir
    q, _ = T.fingerprint_batch(keys[:3], 256)
    owner = T.IndexStore.open(sdir, device="cpu")
    replica = T.IndexStore.open(sdir, device="cpu")
    replica.share_device_tables(owner)
    replica.similar_batch(q, 4, probe="device")
    tables = dict(owner._fp_tables)
    n_live = sum(int(m["count"]) > 0 for m in owner.manifest["shards"])
    assert len(tables) == n_live  # the replica's scan filled the owner's
    owner.similar_batch(q, 4, probe="device")
    assert all(owner._fp_tables[s] is t for s, t in tables.items())
    dev_bytes = sum(a.numel() * a.element_size()
                    for pair in tables.values() for a in pair)
    assert dev_bytes > 0
    # the owner alone counts the shared tables
    assert owner.resident_bytes() == _host_bytes(owner) + dev_bytes
    assert replica.resident_bytes() == _host_bytes(replica)

    idx = T.ByteOffsetIndex(key_mode="full_id")
    idx.add("K/0", "f.sdf", 0)
    idx.save_sharded(sdir.parent / "other_store", n_shards=1)
    other = T.IndexStore.open(sdir.parent / "other_store", device="cpu")
    with pytest.raises(ValueError, match="replicas of one store"):
        other.share_device_tables(owner)
