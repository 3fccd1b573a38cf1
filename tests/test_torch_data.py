"""The port's training data plane and elastic restart against the
reference's, on the CPU: ``FeistelShuffle``/``GlobalSampler`` and
``MixtureSampler`` ids, ``IndexedDataset.batch_for`` arrays on one seeded
corpus (both read paths), all equal bit for bit; ``BatchLoader`` prefetch
and straggler accounting, fetch verification, and ``ElasticPlan`` /
``run_with_failures`` as the reference's tests pin them."""

import tempfile
import time
from pathlib import Path

import numpy as np
import pytest

from repro.core import RecordStore as RRecordStore, build_index as r_build_index
from repro.core.sdfgen import CorpusSpec, generate_corpus
from repro.data.mixture import MixtureSampler as RMixtureSampler
from repro.data.pipeline import IndexedDataset as RIndexedDataset
from repro.data.sampler import FeistelShuffle as RFeistel, GlobalSampler as RGlobalSampler
from repro.runtime.fault import run_with_failures as r_run_with_failures
from repro_torch.core import RecordStore, build_index
from repro_torch.data.mixture import MixtureSampler
from repro_torch.data.pipeline import BatchLoader, IndexedDataset
from repro_torch.data.sampler import FeistelShuffle, GlobalSampler
from repro_torch.runtime.fault import ElasticPlan, FailureLog, run_with_failures


@pytest.fixture(scope="module")
def corpus():
    root = Path(tempfile.mkdtemp()) / "c"
    generate_corpus(root, CorpusSpec(n_files=2, records_per_file=300, salt="torch-data"))
    return root


@pytest.fixture(scope="module")
def datasets(corpus):
    r = RIndexedDataset(RRecordStore(corpus), r_build_index(RRecordStore(corpus)), 96)
    store = RecordStore(corpus)
    p = IndexedDataset(store, build_index(store), 96, device="cpu")
    yield r, p
    r.close()
    p.close()


@pytest.mark.parametrize("n,seed", [(1, 0), (7, 3), (300, 11), (1000, 2**30)])
def test_feistel_equals_reference(n, seed):
    ours, ref = FeistelShuffle(n, seed), RFeistel(n, seed)
    idx = range(0, n, max(1, n // 97))
    assert [ours(i) for i in idx] == [ref(i) for i in idx]


@pytest.mark.parametrize("n_dp", [1, 2, 4])
def test_global_sampler_equals_reference(n_dp):
    ours = GlobalSampler(600, global_batch=8, seed=5)
    ref = RGlobalSampler(600, global_batch=8, seed=5)
    for step in (0, 1, 74, 75, 300):     # 75 steps = one epoch: the wrap too
        for r in range(n_dp):
            assert ours.example_ids(step, r, n_dp) == ref.example_ids(step, r, n_dp)


def test_mixture_sampler_equals_reference():
    kw = dict(sizes=(50, 300, 7), weights=(0.5, 0.3, 0.2), global_batch=8, seed=2)
    ours, ref = MixtureSampler(**kw), RMixtureSampler(**kw)
    for step in (0, 3, 40, 41):
        for r, n_dp in ((0, 1), (1, 2), (3, 4)):
            assert (ours.batch_examples(step, r, n_dp)
                    == ref.batch_examples(step, r, n_dp))
    with pytest.raises(ValueError):
        MixtureSampler(sizes=(1,), weights=(1.0, 2.0), global_batch=2)


def test_dataset_keys_equal_reference(datasets):
    r, p = datasets
    assert p.keys == r.keys and len(p) == len(r)


@pytest.mark.parametrize("workers", [0, 2])
def test_batch_for_equals_reference_bit_for_bit(datasets, workers):
    r, p = datasets
    old = (r.workers, p.workers)
    r.workers = p.workers = workers
    try:
        smp, rsmp = GlobalSampler(len(p), 8, seed=1), RGlobalSampler(len(r), 8, seed=1)
        for step in (0, 5, 37):
            got = p.batch_for(smp, step, 0, 1)
            want = r.batch_for(rsmp, step, 0, 1)
            assert sorted(got) == sorted(want) == ["loss_mask", "tokens"]
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == (8, 96)
                np.testing.assert_array_equal(got[k], want[k])
    finally:
        r.workers, p.workers = old
    assert p.stats.verify_failures == 0


def test_loader_prefetch_and_straggler(datasets):
    _, ds = datasets
    smp = GlobalSampler(len(ds), global_batch=4)
    calls = {"n": 0}

    def flaky(step):
        calls["n"] += 1
        if step == 1 and calls["n"] < 3:
            time.sleep(0.4)
        return ds.batch_for(smp, step, 0, 1)

    before = (ds.stats.deadline_misses, ds.stats.retries)
    bl = BatchLoader(ds, smp, deadline_s=0.05, fetch_fn=flaky)
    bl.start()
    got = [bl.get(timeout=30) for _ in range(3)]
    bl.stop()
    assert [s for s, _ in got] == [0, 1, 2]
    for step, batch in got:
        np.testing.assert_array_equal(batch["tokens"], ds.batch_for(smp, step, 0, 1)["tokens"])
    assert bl.stats.deadline_misses >= before[0] + 1
    assert bl.stats.retries >= before[1] + 1


def test_fetch_verification_detects_corruption(corpus, tmp_path):
    import shutil

    root = tmp_path / "c"
    shutil.copytree(corpus, root)
    store = RecordStore(root)
    ds = IndexedDataset(store, build_index(store), 96, device="cpu")
    key = ds.keys[3]
    fname, off = ds.index.lookup(key)
    path = store.path_of(fname)
    raw = bytearray(path.read_bytes())
    probe = raw[off: off + 2000].find(b" C  ")
    assert probe > 0
    raw[off + probe + 1] = ord("N")   # the first carbon becomes a nitrogen
    path.write_bytes(bytes(raw))
    out = ds.fetch_many([key, ds.keys[4]])
    assert key not in out and ds.keys[4] in out
    assert ds.stats.verify_failures == 1
    ds.close()


def test_dataset_refuses_a_missing_card(corpus):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    store = RecordStore(corpus)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndexedDataset(store, build_index(store), 96)


def test_elastic_plan():
    with pytest.raises(RuntimeError):
        ElasticPlan.for_survivors(0, n_model=2)
    assert ElasticPlan.for_survivors(3, n_model=2).n_dp == 3
    assert ElasticPlan.for_survivors(3, 16).n_dp == 3


@pytest.mark.parametrize("fail_at,initial", [({4: 1, 8: 1}, 4), ({0: 2}, 4), ({}, 2),
                                             ({3: 5}, 2)])
def test_run_with_failures_equals_reference(fail_at, initial):
    def chunks():
        seen = []

        def chunk(start, until, n_dp):
            seen.append((start, until, n_dp))
            return until, {}
        return seen, chunk

    seen, chunk = chunks()
    log = run_with_failures(12, chunk, fail_at=dict(fail_at), initial_dp=initial)
    r_seen, r_chunk = chunks()
    r_log = r_run_with_failures(12, r_chunk, fail_at=dict(fail_at), initial_dp=initial)
    assert seen == r_seen
    strip = lambda events: [{k: v for k, v in e.items() if k != "t"} for e in events]
    assert strip(log.events) == strip(r_log.events)
    if fail_at == {4: 1, 8: 1}:
        assert seen == [(0, 4, 4), (4, 8, 3), (8, 12, 2)]
    if fail_at == {0: 2}:
        assert seen == [(0, 12, 2)]
        assert [e["kind"] for e in log.events] == ["failure", "chunk"]


def test_failure_log_records_time():
    log = FailureLog()
    log.record(kind="x", at=3)
    assert log.events[0]["kind"] == "x" and "t" in log.events[0]
