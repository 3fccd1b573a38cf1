"""The port's query service against the reference package's, on the CPU.

One collision-seeded corpus (16-bit hashed keys) and its stores, served by
``repro``'s ``QueryService`` and by the port's on ``device="cpu"``:
``lookup_batch``, ``fetch``, ``fetch_stream``, ``fetch_aio``,
``extract(service=)``, ``similar`` (coalesced and direct k) must give the
same bytes.  Beside them: the router's scatter path equals its inline
path, two seeded ``FaultInjectingTransport`` runs give identical results,
and the port's copy of the runtime's backoff and heartbeat agrees with
the reference's.
"""

import asyncio
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import repro.core as R
import repro.runtime.fault as r_fault
import repro.service as RS
import repro_torch.core as T
import repro_torch.runtime.fault as t_fault
import repro_torch.service as TS

KEY_BITS = 16  # 1,200 records in a 16-bit key space: seeded mismatches
FP_BITS = 256
SPEC = dict(n_files=3, records_per_file=400, key_bits=KEY_BITS)


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


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("svc") / "corpus"
    R.generate_corpus(root, R.CorpusSpec(**SPEC))
    return root


@pytest.fixture(scope="module")
def targets():
    spec = T.CorpusSpec(**SPEC)
    return T.intersect_host(
        T.db_id_list(spec, "chembl", extra_outside=15),
        T.db_id_list(spec, "emolecules", extra_outside=15),
    ).ids


@pytest.fixture(scope="module")
def hashed_dir(corpus, tmp_path_factory):
    """Hashed-key index (collision runs) published by the reference."""
    idx = R.build_index(R.RecordStore(corpus), key_mode="hashed_key",
                        key_bits=KEY_BITS)
    assert idx.stats.n_duplicate_keys > 0
    sdir = tmp_path_factory.mktemp("svc") / "hashed"
    idx.save_sharded(sdir, n_shards=8, fingerprint_bits=FP_BITS)
    return sdir


@pytest.fixture(scope="module")
def full_dir(corpus, tmp_path_factory):
    """Full-id index published by the port."""
    idx = T.build_index(T.RecordStore(corpus), key_mode="full_id")
    sdir = tmp_path_factory.mktemp("svc") / "full"
    idx.save_sharded(sdir, n_shards=8, fingerprint_bits=FP_BITS)
    return sdir, sorted(idx.entries.keys())


def _services(corpus, sdir, **kw):
    ref = RS.QueryService(R.RecordStore(corpus), sdir, RS.ServiceConfig(**kw))
    port = TS.QueryService(T.RecordStore(corpus), sdir,
                           TS.ServiceConfig(device="cpu", **kw))
    return ref, port


def _same_extraction(a, b):
    assert list(a.records.items()) == list(b.records.items())
    assert a.missing == b.missing
    assert _mismatches(a) == _mismatches(b)


def _mismatches(res):
    """The mismatches as plain tuples (the two packages' classes differ)."""
    return [dataclasses.astuple(m) for m in res.mismatches]


def _same_arrays(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the service surfaces, port against reference
# ---------------------------------------------------------------------------

def test_lookup_batch_matches_reference(corpus, full_dir):
    sdir, keys = full_dir
    probe = keys[::3] + [f"InChI=1S/absent/{i}" for i in range(200)]
    ref, port = _services(corpus, sdir, replicas=2)
    with ref, port:
        _same_arrays(port.lookup_batch(probe), ref.lookup_batch(probe))
        assert port.lookup(probe[:50]) == ref.lookup(probe[:50])
        assert (port.plan(keys[:40])[0] == ref.plan(keys[:40])[0])
        st_p, st_r = port.stats()["store"], ref.stats()["store"]
        assert st_p == st_r


def test_fetch_paths_match_reference_on_collision_seeded_store(
    corpus, targets, hashed_dir
):
    serial = R.extract(R.RecordStore(corpus), R.IndexStore.open(hashed_dir),
                       targets, key_bits=KEY_BITS, workers=0)
    assert serial.mismatches and serial.missing
    ref, port = _services(corpus, hashed_dir, replicas=2)
    with ref, port:
        want = ref.fetch(targets, key_bits=KEY_BITS)
        _same_extraction(want, serial)
        _same_extraction(port.fetch(targets, key_bits=KEY_BITS), want)
        _same_extraction(
            T.extract(T.RecordStore(corpus), None, targets,
                      key_bits=KEY_BITS, service=port),
            R.extract(R.RecordStore(corpus), None, targets,
                      key_bits=KEY_BITS, service=ref),
        )
        _same_extraction(
            asyncio.run(port.fetch_aio(targets, key_bits=KEY_BITS)), want)
        _same_extraction(
            port.fetch_async(targets, key_bits=KEY_BITS).result(timeout=60),
            want)
        got_res, want_res = T.ExtractionResult(), R.ExtractionResult()
        got = sorted(port.fetch_stream(targets, key_bits=KEY_BITS,
                                       result=got_res))
        exp = sorted(ref.fetch_stream(targets, key_bits=KEY_BITS,
                                      result=want_res))
        assert got == exp and got
        assert got_res.missing == want_res.missing
        assert sorted(_mismatches(got_res)) == sorted(_mismatches(want_res))
        streamed = sorted(T.extract_iter(T.RecordStore(corpus), None, targets,
                                         key_bits=KEY_BITS, service=port))
        assert streamed == exp
        assert port.stats()["read"]["records"] > 0


def test_similar_matches_reference_coalesced_and_direct(corpus, full_dir):
    sdir, keys = full_dir
    q, _ = T.fingerprint_batch(keys[::50][:12], FP_BITS)
    ref, port = _services(corpus, sdir, replicas=2, similar_top_k=8)
    with ref, port:
        outs = {}

        def client(i):
            outs[i] = port.similar(q[2 * i : 2 * i + 2], 3)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i, got in outs.items():
            _same_arrays(got, ref.similar(q[2 * i : 2 * i + 2], 3))
        # k above similar_top_k probes alone, uncoalesced
        _same_arrays(port.similar(q, 20), ref.similar(q, 20))
        _same_arrays(port.similar(q[0], 2), ref.similar(q[0], 2))
        sim = port.stats()["similarity"]
        assert sim["fingerprint_bits"] == FP_BITS
        assert sim["scheduler"]["requests"] >= 6
        assert sim["fp_rows_scanned"] > 0
        assert set(port.stats()) == set(ref.stats())
        assert set(sim) == set(ref.stats()["similarity"])
        with pytest.raises(ValueError):
            port.similar(q[:1], 0)
        empty = port.similar(np.zeros((0, q.shape[1]), np.uint32), 4)
        assert empty.scores.shape == (0, 4)


def test_similar_service_async_on_the_event_loop(corpus, full_dir):
    sdir, keys = full_dir
    q, _ = T.fingerprint_batch(keys[:4], FP_BITS)
    ref, port = _services(corpus, sdir, replicas=1)
    with ref, port:
        async def go():
            futs = [port.similar_async(q[i : i + 1], 3) for i in range(4)]
            return [await asyncio.wrap_future(f) for f in futs]

        for i, got in enumerate(asyncio.run(go())):
            _same_arrays(got, ref.similar(q[i : i + 1], 3))


def test_service_entry_point_defaults_to_cuda(corpus, full_dir):
    assert TS.ServiceConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.QueryService(T.RecordStore(corpus), full_dir[0])


# ---------------------------------------------------------------------------
# router: scatter == inline
# ---------------------------------------------------------------------------

def test_router_scatter_equals_inline(full_dir):
    sdir, keys = full_dir
    probe = keys[::2] + [f"InChI=1S/absent/{i}" for i in range(100)]
    q, _ = T.fingerprint_batch(keys[::97][:6], FP_BITS)
    with TS.ShardRouter(sdir, replicas=2, min_scatter_keys=1,
                        device="cpu") as rt:
        scattered = rt.lookup_batch(probe)
        sim_scattered = rt.similar_batch(q, 4)
        assert rt.stats.scattered >= 1 and rt.stats.similar_scattered == 1
    with TS.ShardRouter(sdir, replicas=1, device="cpu") as rt:
        inline = rt.lookup_batch(probe)
        sim_inline = rt.similar_batch(q, 4)
        assert rt.stats.similar_inline == 1
    _same_arrays(scattered, inline)
    _same_arrays(sim_scattered, sim_inline)
    with RS.ShardRouter(sdir, replicas=2, min_scatter_keys=1) as rt:
        _same_arrays(scattered, rt.lookup_batch(probe))
        _same_arrays(sim_scattered, rt.similar_batch(q, 4))


def test_router_replicas_share_device_tables(full_dir):
    sdir, keys = full_dir
    q, _ = T.fingerprint_batch(keys[:5], FP_BITS)
    with TS.ShardRouter(sdir, replicas=3, device="cpu") as rt:
        for _ in range(4):  # round-robin: every replica scans
            rt.similar_batch(q, 4)
        stores = rt._stores
        assert all(st._fp_tables is stores[0]._fp_tables for st in stores)
        assert [st._owns_tables for st in stores] == [True, False, False]


def test_replicas_upload_each_shard_plane_once_under_concurrency(
    full_dir, monkeypatch
):
    """Scatter threads racing the first scan of a shard share one upload:
    with more threads than cores and a tiny switch interval, each shard's
    plane and counts are copied to the device exactly once."""
    import sys

    import repro_torch.core.store as store_mod

    sdir, keys = full_dir
    q, _ = T.fingerprint_batch(keys[:3], FP_BITS)
    uploads = []
    real = store_mod._host_tensor
    monkeypatch.setattr(store_mod, "_host_tensor",
                        lambda a: uploads.append(a.shape) or real(a))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with TS.ShardRouter(sdir, replicas=2, device="cpu",
                            probe="device") as rt:
            threads = [threading.Thread(target=rt.similar_batch, args=(q, 3))
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            n_live = sum(int(m["count"]) > 0
                         for m in rt._stores[0].manifest["shards"])
            assert len(rt._stores[0]._fp_tables) == n_live
    finally:
        sys.setswitchinterval(old)
    assert len(uploads) == 2 * n_live  # (plane, counts) once per shard


# ---------------------------------------------------------------------------
# fault injection: two seeded runs give identical results
# ---------------------------------------------------------------------------

def _chaos_router(sdir, seed=42):
    injectors = []

    def factory(st, i):
        tr = TS.FaultInjectingTransport(
            TS.LocalTransport(st, name=f"r{i}"), seed=seed + i)
        injectors.append(tr)
        return tr

    rt = TS.ShardRouter(
        sdir, replicas=2, device="cpu", min_scatter_keys=1,
        transport_factory=factory, probe_timeout_ms=400.0,
        hedge_floor_ms=5.0, fail_threshold=1,
        health_backoff=t_fault.BackoffPolicy(base_s=0.1, cap_s=0.5),
    )
    return rt, injectors


def test_fault_injecting_runs_are_identical(full_dir):
    sdir, keys = full_dir
    probe = keys[:240]
    q, _ = T.fingerprint_batch(keys[:4], FP_BITS)
    with TS.ShardRouter(sdir, replicas=2, min_scatter_keys=1,
                        device="cpu") as clean:
        baseline = clean.lookup_batch(probe)
    dead, slow = 2, 5

    def chaos_run():
        rt, inj = _chaos_router(sdir)
        try:
            for tr in inj:
                tr.kill(shard=dead)
                tr.set_latency(30.0, jitter_ms=10.0, shard=slow)
            out = [rt.lookup_batch_ex(probe) for _ in range(3)]
            sim = rt.similar_batch_ex(q, 5)
            hedges = rt.stats.hedges_fired
            for tr in inj:
                tr.revive(shard=dead)
                tr.clear()
            deadline = time.monotonic() + 10.0
            post = rt.lookup_batch_ex(probe)
            while post.degraded.any() and time.monotonic() < deadline:
                time.sleep(0.1)
                post = rt.lookup_batch_ex(probe)
            return out, sim, post, hedges
        finally:
            rt.close()

    a_out, a_sim, a_post, a_hedges = chaos_run()
    b_out, b_sim, b_post, _ = chaos_run()
    for ra, rb in zip(a_out, b_out):
        _same_arrays(ra, rb)
    _same_arrays(a_sim, b_sim)
    assert a_sim.degraded.all()
    assert a_hedges > 0
    sid = T.shard_of(T.digest_u64(probe), 8, 64)
    np.testing.assert_array_equal(a_out[0].degraded, sid == dead)
    for post in (a_post, b_post):
        assert not post.degraded.any()
        _same_arrays((post.file_ids, post.offsets, post.hit), baseline)


def test_transport_fault_sequence_is_seed_deterministic(full_dir):
    sdir, keys = full_dir
    st = T.IndexStore.open(sdir, device="cpu")
    probe = keys[:30]
    dg = T.digest_u64(probe)
    s = int(T.shard_of(dg, st.n_shards, st.digest_bits)[0])

    def run_seq(seed):
        tr = TS.FaultInjectingTransport(TS.LocalTransport(st), seed=seed)
        tr.set_error_rate(0.5, shard=s)
        outcomes = []
        for _ in range(24):
            try:
                tr.lookup_shard(s, probe[:4], dg[:4])
                outcomes.append("ok")
            except TS.FlakyError:
                outcomes.append("flaky")
        return outcomes

    a, b, c = run_seq(7), run_seq(7), run_seq(8)
    assert a == b and "flaky" in a and "ok" in a and a != c


# ---------------------------------------------------------------------------
# the runtime's copy
# ---------------------------------------------------------------------------

def test_backoff_and_heartbeat_match_reference(tmp_path):
    for kw in ({}, {"base_s": 0.1, "cap_s": 0.5}, {"multiplier": 3.0}):
        a, b = r_fault.BackoffPolicy(**kw), t_fault.BackoffPolicy(**kw)
        assert [a.delay(i) for i in range(10)] == [b.delay(i) for i in range(10)]
    with pytest.raises(ValueError):
        t_fault.BackoffPolicy().delay(-1)
    t_fault.Heartbeat(tmp_path, 0).beat(5)
    r_fault.Heartbeat(tmp_path, 1).beat(6)
    assert r_fault.Heartbeat(tmp_path, 0).read()["step"] == 5
    assert t_fault.Heartbeat(tmp_path, 1).read()["step"] == 6
    det = t_fault.FailureDetector(tmp_path, 3, timeout=60.0)
    assert det.alive() == [0, 1] and det.dead() == [2]
