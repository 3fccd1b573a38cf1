"""The port's funnel against the reference package's, on the CPU.

Same inputs through both packages: the corpus, the index, the
intersection, the sharded store (written by either, opened by either),
``lookup_batch`` with its ``QueryStats`` (host probe against the device
probe, which on a CPU store runs ``sorted_probe``'s plain version), and
``extract`` with seeded mismatches and misses.  Finally the port's funnel
launcher runs end to end on ``--device cpu``.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.core.sdfgen import CorpusSpec as RSpec
from repro_torch.core.sdfgen import CorpusSpec as TSpec
from repro_torch.launch import funnel

# 1200 records hashed into a 16-bit key space: E[collisions] ≈ 11, so the
# hashed-key extraction seeds real mismatches (and extra_outside real misses)
KEY_BITS = 16
SPEC = dict(n_files=3, records_per_file=400, key_bits=KEY_BITS)


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpora")
    R.generate_corpus(root / "ref", RSpec(**SPEC))
    T.generate_corpus(root / "port", TSpec(**SPEC))
    return root / "ref", root / "port"


@pytest.fixture(scope="module")
def targets():
    spec = TSpec(**SPEC)
    return T.intersect_host(
        T.db_id_list(spec, "chembl", extra_outside=15),
        T.db_id_list(spec, "emolecules", extra_outside=15),
    ).ids


def _synth_entries(n, n_files=7):
    return [(f"InChI=1S/synthetic/{i}", f"f_{i % n_files:02d}.sdf", i * 100)
            for i in range(n)]


def _both_indexes(entries):
    a, b = R.ByteOffsetIndex(), T.ByteOffsetIndex()
    for key, f, off in entries:
        a.add(key, f, off)
        b.add(key, f, off)
    return a, b


def _stats(st):
    return dataclasses.asdict(st)


# ---------------------------------------------------------------------------
# corpus, index, intersection
# ---------------------------------------------------------------------------

def test_corpus_is_byte_identical(corpora):
    ref, port = corpora
    names = sorted(p.name for p in ref.glob("*.sdf"))
    assert names == sorted(p.name for p in port.glob("*.sdf")) and names
    for name in names:
        assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    mr, mp = (json.loads((d / "manifest.json").read_text()) for d in corpora)
    assert mr["spec"] == mp["spec"] and mr["total_bytes"] == mp["total_bytes"]


@pytest.mark.parametrize("key_mode", ["full_id", "hashed_key"])
def test_index_entries_identical(corpora, key_mode):
    ref, _ = corpora
    a = R.build_index(R.RecordStore(ref), key_mode=key_mode, key_bits=KEY_BITS)
    b = T.build_index(T.RecordStore(ref), key_mode=key_mode, key_bits=KEY_BITS)
    assert a.entries == b.entries and a.entries
    assert a.shadowed == b.shadowed
    assert a.stats.n_duplicate_keys == b.stats.n_duplicate_keys


def test_intersection_identical():
    spec_r, spec_t = RSpec(**SPEC), TSpec(**SPEC)
    lists_r = [R.db_id_list(spec_r, db, extra_outside=9) for db in ("chembl", "emolecules")]
    lists_t = [T.db_id_list(spec_t, db, extra_outside=9) for db in ("chembl", "emolecules")]
    assert lists_r == lists_t
    want = R.intersect_host(*lists_r).ids
    assert T.intersect_host(*lists_t).ids == want
    assert T.intersect_sorted(*lists_t, digest_bits=12).ids == want
    assert R.intersect_sorted(*lists_r, digest_bits=12).ids == want


# ---------------------------------------------------------------------------
# store: device probe == host probe, cross-open both ways
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def collision_store(tmp_path_factory):
    """~10k keys with digests narrowed to 18 bits: seeded collision runs
    (the 24-bit pattern of test_store.py's 100k-key parity test, narrowed
    so that 10k keys still give ~190 colliding pairs)."""
    n = 10_000
    entries = _synth_entries(n)
    ref_idx, port_idx = _both_indexes(entries)
    root = tmp_path_factory.mktemp("store") / "s"
    T.save_sharded(port_idx, root, n_shards=8, digest_bits=18)
    keys = [k for k, _, _ in entries]
    keys += [f"InChI=1S/absent/{i}" for i in range(500)]
    return root, ref_idx, keys


def test_lookup_device_probe_equals_host_with_stats(collision_store):
    root, ref_idx, keys = collision_store
    out = {}
    for probe in ("host", "device"):
        qs = T.IndexStore.open(root, device="cpu")
        out[probe] = (qs.lookup_batch(keys, probe=probe), _stats(qs.stats))
    (fh, oh, hh), sh = out["host"]
    (fd, od, hd), sd = out["device"]
    np.testing.assert_array_equal(fh, fd)
    np.testing.assert_array_equal(oh, od)
    np.testing.assert_array_equal(hh, hd)
    assert sh == sd
    assert sh["verify_collisions"] > 0  # collision runs were walked
    assert int(hh.sum()) == len(ref_idx)
    # and both agree with the reference store on the same directory
    rs = R.IndexStore.open(root)
    rf, ro, rh = rs.lookup_batch(keys, probe="host")
    np.testing.assert_array_equal(rf, fh)
    np.testing.assert_array_equal(ro, oh)
    np.testing.assert_array_equal(rh, hh)
    rstats = _stats(rs.stats)
    assert {k: rstats[k] for k in sh} == sh


def test_pinned_plane_device_probe_equals_per_shard(collision_store):
    root, _, keys = collision_store
    base = T.IndexStore.open(root, device="cpu")
    want = base.lookup_batch(keys, probe="host")
    qs = T.IndexStore.open(root, device="cpu")
    qs.preload_digest_plane()
    assert qs._probe_plane is not None and qs._probe_plane.dtype == torch.uint32
    got = qs.lookup_batch(keys, probe="device")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    assert _stats(qs.stats) == _stats(base.stats)
    replica = T.IndexStore.open(root, device="cpu")
    replica.adopt_planes(qs.preload_digest_plane())
    # the device table is shared, not uploaded again, and counted once
    assert replica._probe_plane is qs._probe_plane
    plane_bytes = qs._probe_plane.numel() * 4
    assert qs.resident_bytes() >= plane_bytes > replica.resident_bytes()
    for a, b in zip(want, replica.lookup_batch(keys, probe="device")):
        np.testing.assert_array_equal(a, b)


def test_device_tables_upload_once_and_count_as_resident(collision_store):
    root, _, keys = collision_store
    qs = T.IndexStore.open(root, device="cpu")
    before = qs.resident_bytes()
    qs.lookup_batch(keys[:200], probe="device")
    tables = dict(qs._probe_tables)
    assert tables and all(t.shape[1] == 2 for t in tables.values())
    qs.lookup_batch(keys[:200], probe="device")
    assert all(qs._probe_tables[s] is t for s, t in tables.items())
    dev_bytes = sum(t.numel() * 4 for t in tables.values())
    assert qs.resident_bytes() >= before + dev_bytes


def test_store_directories_cross_open(tmp_path):
    entries = _synth_entries(3000, n_files=5)
    ref_idx, port_idx = _both_indexes(entries)
    R.save_sharded(ref_idx, tmp_path / "r", n_shards=4, digest_bits=20)
    T.save_sharded(port_idx, tmp_path / "t", n_shards=4, digest_bits=20)
    # the two packages write the same bytes
    files = sorted(p.name for p in (tmp_path / "r").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "t").iterdir())
    for name in files:
        assert (tmp_path / "r" / name).read_bytes() == \
            (tmp_path / "t" / name).read_bytes(), name
    keys = [k for k, _, _ in entries][::7] + ["InChI=1S/absent/x"]
    want = [ref_idx.lookup(k) for k in keys]
    assert T.IndexStore.open(tmp_path / "r", device="cpu").locate_batch(
        keys, probe="device") == want
    assert R.IndexStore.open(tmp_path / "t").locate_batch(keys) == want


# ---------------------------------------------------------------------------
# extract
# ---------------------------------------------------------------------------

def _as_tuples(mismatches):
    return [dataclasses.astuple(m) for m in mismatches]


@pytest.mark.parametrize("verify_backend", ["auto", "digest", "vector"])
def test_extract_identical_to_reference(corpora, targets, tmp_path, verify_backend):
    ref, _ = corpora
    r_idx = R.build_index(R.RecordStore(ref), key_mode="hashed_key", key_bits=KEY_BITS)
    want = R.extract(R.RecordStore(ref), r_idx, targets, key_bits=KEY_BITS)
    assert want.mismatches and want.missing  # both paths seeded

    t_store = T.RecordStore(ref)
    t_idx = T.build_index(t_store, key_mode="hashed_key", key_bits=KEY_BITS)
    t_idx.save_sharded(tmp_path / "s", n_shards=4)
    qs = T.IndexStore.open(tmp_path / "s", device="cpu")
    got = T.extract(t_store, qs, targets, key_bits=KEY_BITS,
                    verify_backend=verify_backend, device="cpu")
    assert list(got.records.items()) == list(want.records.items())
    assert got.missing == want.missing
    assert _as_tuples(got.mismatches) == _as_tuples(want.mismatches)


def test_digest_compare_matches_string_compare():
    ids = [f"InChI=1S/C{i}H{2 * i}/c1-{i}" for i in range(50)]
    other = list(ids)
    other[3] = other[3] + "x"
    other[17] = ""
    want = [a == b for a, b in zip(ids, other)]
    assert T.compare_ids_batch(ids, other, "digest", device="cpu") == want
    assert T.compare_ids_batch(ids, other, "auto", device="cpu") == want
    assert T.compare_ids_batch(ids, other, "string", device="cpu") == want


# ---------------------------------------------------------------------------
# device policy and the launcher
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda(collision_store, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, _, _ = collision_store
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.IndexStore.open(root)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.VerifyBatcher()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.extract(None, None, [])
    assert T.IndexStore.open(root, device="cpu").device.type == "cpu"
    assert T.VerifyBatcher(device="cpu").device.type == "cpu"


def test_funnel_launcher_runs_on_cpu(capsys, monkeypatch):
    summary = funnel.run_funnel(400, seed=0, device="cpu", workers=1,
                                log=lambda s: None)
    spec = funnel.funnel_spec(400)
    assert summary["extracted"] == len(T.ground_truth_intersection(spec))
    assert summary["with_property"] == len(T.ground_truth_final_dataset(spec))
    assert summary["lookup_stats"]["hits"] == 400
    assert summary["lookup_keys"] == 400 + funnel.MISSES
    assert summary["hashed_mismatches"] > 0  # the digest compare rejected them
    # the CLI's index build would fork 4 workers; this process runs threads
    monkeypatch.setattr(funnel, "run_funnel", functools.partial(
        funnel.run_funnel, workers=1, log=lambda s: None))
    funnel.main(["--records", "200", "--seed", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["records"] == 200
    assert out["extracted"] == len(
        T.ground_truth_intersection(funnel.funnel_spec(200, seed=3)))
