"""The paper's integration funnel end to end on the port.

The counterpart of ``examples/quickstart.py``: generate the corpus, build
the byte-offset index (Algorithm 2), publish it with ``save_sharded``,
intersect the ChEMBL/eMolecules id lists (Eq. 1), answer
``IndexStore.lookup_batch`` with the ``sorted_probe`` kernel, and extract
and verify the records (Algorithm 3) with the ``hash_mix`` kernel in the
verifier.  It asserts what the quickstart asserts — extraction equals
``ground_truth_intersection`` and the property filter equals
``ground_truth_final_dataset`` — and, beside it, that the device paths
agree with the host paths on the same store:

* ``lookup_batch(probe="device")`` equals ``probe="host"`` for every
  corpus key plus 2,000 absent keys, ``QueryStats`` included;
* ``extract`` through the device verifier gives the same ``records`` /
  ``missing`` / ``mismatches`` as ``verify_backend="string"``;
* the same holds on an index of keys hashed to ``hashed_bits(records)``
  bits, whose collisions seed real mismatches for the verifier to reject.

Then the two host phases of the paper's narrative (``examples/
integrate_databases.py`` in the reference package):

* §VI's systematic collision scan at that key width: ``scan_corpus`` (the
  dict path) must equal ``scan_pairs_sorted`` and ``collisions_from_pairs``
  on the same (key, id) pairs, every mismatch the verifier rejected must
  lie inside a colliding group, and Eq. 4's empirical rate is printed
  beside Eq. 5's ``birthday_expectation``;
* Algorithm 1's brute-force baseline: ``naive_scan`` of a few targets
  must find the records extraction found; ``measure_scan_throughput``
  (Table I) and a list-membership scan's comparison rate project Eq. 2/3's
  runtime to PubChem's 176,929,690 records and 477,123 targets, printed
  beside the indexed path's measured seconds and the ratio between them.

    PYTHONPATH=src python -m repro_torch.launch.funnel --records 100000 --seed 0 --device cuda

The corpus is ``FILES`` files published as ``SHARDS`` shards.  The index
build forks worker processes; they only scan files and never touch CUDA,
so the fork is safe even after the card is initialised.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..core import (
    IndexStore,
    QueryStats,
    RecordStore,
    birthday_expectation,
    build_index,
    collisions_from_pairs,
    estimate_runtime,
    extract,
    extract_property,
    hashed_key,
    intersect_host,
    intersect_sorted,
    iter_records,
    measure_scan_throughput,
    naive_scan,
    scan_corpus,
    scan_pairs_sorted,
)
from ..core.sdfgen import (
    PROP_ID,
    PROP_XLOGP,
    CorpusSpec,
    db_id_list,
    generate_corpus,
    ground_truth_final_dataset,
    ground_truth_intersection,
)
from ..device import DeviceLike, resolve_device

__all__ = ["funnel_spec", "run_funnel"]

FILES = 8      # the reference corpus's default file count
SHARDS = 16    # save_sharded's default shard count
MISSES = 2000  # absent keys added to the lookup parity check
# Eq. 2/3's projection: PubChem's records and the paper's targets
# (ChEMBL ∩ eMolecules)
PUBCHEM_RECORDS = 176_929_690
PAPER_TARGETS = 477_123
BASELINE_TARGETS = 4      # targets Algorithm 1 scans for, checked against extract
CMP_TARGETS = 300         # list-membership targets of the comparison-rate scan

_DEFAULT_SALT = CorpusSpec().salt


def funnel_spec(records: int, seed: int = 0) -> CorpusSpec:
    """The corpus of a funnel run: ``records`` split over ``FILES`` files.

    Seed 0 is the reference package's default corpus; any other seed
    salts the generator, giving another corpus of the same shape.
    """
    if records < FILES or records % FILES:
        raise ValueError(f"records ({records}) must be a multiple of {FILES}")
    salt = _DEFAULT_SALT if seed == 0 else f"{_DEFAULT_SALT}:seed{seed}"
    return CorpusSpec(n_files=FILES, records_per_file=records // FILES, salt=salt)


def hashed_bits(records: int) -> int:
    """Key width of the collision check: about one target in two shares
    its hashed key with another record."""
    return records.bit_length()


def _id_pairs(store: RecordStore, bits: int):
    """``(hashed_key, full_id)`` of every record, in file order."""
    pairs = []
    for path in store.files():
        for _off, text in iter_records(path):
            full_id = extract_property(text, PROP_ID)
            if full_id is not None:
                pairs.append((hashed_key(full_id, bits), full_id))
    return pairs


def collision_phase(store: RecordStore, bits: int, mismatches, log=print):
    """§VI's systematic scan at ``bits``-bit keys, cross-checked; raises on
    any disagreement.  Returns a summary."""
    t = time.perf_counter()
    rep = scan_corpus(store, key_bits=bits)
    scan_s = time.perf_counter() - t
    pairs = _id_pairs(store, bits)
    keys, ids = [k for k, _ in pairs], [i for _, i in pairs]
    if scan_pairs_sorted(keys, ids) != rep.colliding:
        raise AssertionError(f"{bits}-bit keys: scan_pairs_sorted != scan_corpus")
    if collisions_from_pairs(pairs) != rep.colliding:
        raise AssertionError(f"{bits}-bit keys: collisions_from_pairs != scan_corpus")
    # a target the corpus holds was fetched as another record of its
    # colliding group, and each group serves one of its records right; a
    # target the corpus lacks (the lists' extra ids) hit a record's key
    held = set(ids)
    inside = [m for m in mismatches if m.expected_id in held]
    for m in inside:
        group = rep.colliding.get(m.lookup_key, ())
        if m.expected_id not in group or m.found_id not in group:
            raise AssertionError(f"mismatch of key {m.lookup_key} outside its "
                                 "colliding group")
    if len(inside) > rep.n_affected_records - rep.n_colliding_keys:
        raise AssertionError(f"{len(inside)} mismatches, more than the "
                             "collisions can cause")
    for m in mismatches:
        if m.expected_id not in held and hashed_key(m.found_id, bits) != m.lookup_key:
            raise AssertionError(f"mismatch of key {m.lookup_key}: the record "
                                 "found has another key")
    expected = birthday_expectation(rep.n_records, bits)
    log(f"§VI scan at {bits}-bit keys: {rep.n_colliding_keys} colliding keys "
        f"affecting {rep.n_affected_records} of {rep.n_records} records "
        f"(scan_corpus == scan_pairs_sorted); Eq. 4 empirical rate "
        f"{rep.empirical_rate:.4e}; Eq. 5 birthday expectation {expected:.1f}; "
        f"of the verifier's {len(mismatches)} mismatches, {len(inside)} are "
        f"targets fetched as another record of their colliding group and "
        f"{len(mismatches) - len(inside)} are absent targets whose key a "
        "record holds")
    return {"key_bits": bits, "records": rep.n_records,
            "colliding_keys": rep.n_colliding_keys,
            "affected_records": rep.n_affected_records,
            "empirical_rate": rep.empirical_rate,
            "birthday_expectation": expected,
            "mismatches": len(mismatches), "collision_mismatches": len(inside),
            "scan_s": scan_s}


def baseline_phase(store: RecordStore, targets, extracted, indexed_s: float,
                   log=print):
    """Algorithm 1 against the indexed path; raises if the brute-force scan
    disagrees with ``extracted`` (extraction's records).  ``indexed_s`` is
    the indexed path's measured seconds for all ``targets``.  Returns a
    summary."""
    held = [t for t in targets if t in extracted]
    step = max(1, len(held) // BASELINE_TARGETS)
    few = held[::step][:BASELINE_TARGETS]
    res = naive_scan(store, few, membership="set")
    if res.missing or ({t: r.strip() for t, r in res.records.items()}
                       != {t: extracted[t].strip() for t in few}):
        raise AssertionError("naive_scan disagrees with extract")
    samples = measure_scan_throughput(store, n_files=3)
    scan_rate = (sum(s.records for s in samples)
                 / max(sum(s.seconds for s in samples), 1e-9))
    cmp = naive_scan(store, list(targets[:CMP_TARGETS]), membership="list",
                     max_files=1)
    cmp_rate = cmp.comparisons / max(cmp.seconds, 1e-9)
    ops, naive_s = estimate_runtime(PAPER_TARGETS, 1, PUBCHEM_RECORDS, cmp_rate)
    _, set_s = estimate_runtime(PAPER_TARGETS, 1, PUBCHEM_RECORDS, scan_rate, "set")
    per_target = indexed_s / max(len(targets), 1)
    indexed_proj = per_target * PAPER_TARGETS
    log(f"Algorithm 1: {len(few)} targets found by a {res.records_scanned}-record "
        f"scan in {res.seconds:.3f} s (== extract); Table I scan rate "
        f"{scan_rate:.0f} records/s over {len(samples)} files; Eq. 2/3 at "
        f"{PUBCHEM_RECORDS} records x {PAPER_TARGETS} targets: {ops:.4e} "
        f"comparisons at {cmp_rate:.4e}/s = {naive_s:.4e} s ({naive_s / 86400:.1f} "
        f"days; one set-membership pass {set_s:.1f} s); indexed path "
        f"{indexed_s:.3f} s for {len(targets)} targets, {per_target * 1e3:.4f} ms "
        f"a target, {indexed_proj:.1f} s projected: {naive_s / indexed_proj:.1f}x")
    return {"targets_checked": len(few), "scan_records_per_s": scan_rate,
            "comparisons_per_s": cmp_rate, "projected_ops": ops,
            "projected_naive_s": naive_s, "projected_set_scan_s": set_s,
            "indexed_s": indexed_s, "indexed_per_target_s": per_target,
            "projected_indexed_s": indexed_proj,
            "ratio": naive_s / indexed_proj, "naive_s": res.seconds}


def _lookup_once(store: IndexStore, keys, probe: str):
    """One ``lookup_batch`` with the store's stats isolated to this call."""
    store.stats = QueryStats()
    t0 = time.perf_counter()
    out = store.lookup_batch(keys, probe=probe)
    return out, store.stats, time.perf_counter() - t0


def run_funnel(
    records: int,
    seed: int = 0,
    device: DeviceLike = "cuda",
    workers: int = 4,
    log=print,
    workdir: Optional[Union[str, Path]] = None,
) -> Dict[str, object]:
    """Run the funnel; raise on any disagreement.

    ``workers`` is the index build's process count.  Without ``workdir``
    the run lives in a temporary directory, removed at the end; with one,
    it writes there and keeps ``corpus/`` and the published ``store/``
    for a caller to serve.  Returns a summary.
    """
    dev = resolve_device(device)
    spec = funnel_spec(records, seed)
    keep = workdir is not None
    root = Path(workdir) if keep else Path(tempfile.mkdtemp(prefix="funnel_"))
    root.mkdir(parents=True, exist_ok=True)
    seconds: Dict[str, float] = {}
    try:
        t_all = time.perf_counter()
        t = time.perf_counter()
        manifest = generate_corpus(root / "corpus", spec)
        store = RecordStore(root / "corpus")
        seconds["generate"] = time.perf_counter() - t
        log(f"corpus: {spec.n_files} files x {spec.records_per_file} records, "
            f"{manifest.total_bytes} bytes")

        t = time.perf_counter()
        idx = build_index(store, key_mode="full_id", workers=workers)
        seconds["index"] = time.perf_counter() - t
        t = time.perf_counter()
        idx.save_sharded(root / "store", n_shards=SHARDS)
        seconds["publish"] = time.perf_counter() - t
        log(f"index: {len(idx)} entries, published as {SHARDS} shards")

        t = time.perf_counter()
        chembl = db_id_list(spec, "chembl", extra_outside=30)
        emol = db_id_list(spec, "emolecules", extra_outside=30)
        inter = intersect_host(chembl, emol)
        if intersect_sorted(chembl, emol).ids != inter.ids:
            raise AssertionError("host and sorted-merge intersections disagree")
        seconds["intersect"] = time.perf_counter() - t
        log(f"ChEMBL ∩ eMolecules = {inter.count}")

        qs = IndexStore.open(root / "store", device=dev)
        keys = list(idx.entries.keys())
        keys += [f"InChI=1S/absent/{seed}/{i}" for i in range(MISSES)]
        (f_d, o_d, h_d), st_d, sec_d = _lookup_once(qs, keys, "device")
        (f_h, o_h, h_h), st_h, _ = _lookup_once(qs, keys, "host")
        if not (np.array_equal(f_d, f_h) and np.array_equal(o_d, o_h)
                and np.array_equal(h_d, h_h)):
            raise AssertionError("device and host lookup_batch disagree")
        if st_d != st_h:
            raise AssertionError(f"QueryStats differ: device {st_d} host {st_h}")
        if int(h_d.sum()) != len(idx):
            raise AssertionError(f"{int(h_d.sum())} hits for {len(idx)} entries")
        seconds["lookup_device"] = sec_d
        log(f"lookup_batch: {len(keys)} keys, device == host, "
            f"{st_d.hits} hits, {st_d.verify_collisions} collisions")

        t = time.perf_counter()
        res = extract(store, qs, inter.ids, device=dev)
        seconds["extract"] = time.perf_counter() - t
        ref = extract(store, qs, inter.ids, verify_backend="string", device=dev)
        if (res.records != ref.records or res.missing != ref.missing
                or res.mismatches != ref.mismatches):
            raise AssertionError("device verifier and string verifier disagree")

        with_prop = sum(
            1 for r in res.records.values()
            if extract_property(r, PROP_XLOGP) is not None
        )
        gt = ground_truth_intersection(spec)
        gt_final = ground_truth_final_dataset(spec)
        if res.found != len(gt):
            raise AssertionError(f"extracted {res.found}, ground truth {len(gt)}")
        if with_prop != len(gt_final):
            raise AssertionError(
                f"property filter {with_prop}, ground truth {len(gt_final)}"
            )
        log(f"extracted {res.found} (missing {len(res.missing)}, mismatches "
            f"{len(res.mismatches)}), with property {with_prop}: ground truth "
            "reproduced")

        # Full ids never collide, so the run above only shows that the
        # digest compare gives equal ids equal digests.  Keys hashed to
        # hashed_bits(records) bits do collide: the plan then points
        # targets at other records, and the device verifier must reject
        # exactly the rows the string verifier rejects.
        t = time.perf_counter()
        bits = hashed_bits(spec.n_records)
        h_idx = build_index(store, key_mode="hashed_key", key_bits=bits,
                            recompute_keys=True, workers=workers)
        h_idx.save_sharded(root / "hashed", n_shards=SHARDS)
        hs = IndexStore.open(root / "hashed", device=dev)
        h_res = extract(store, hs, inter.ids, key_bits=bits, device=dev)
        h_ref = extract(store, hs, inter.ids, key_bits=bits,
                        verify_backend="string", device=dev)
        if (h_res.records != h_ref.records or h_res.missing != h_ref.missing
                or h_res.mismatches != h_ref.mismatches):
            raise AssertionError(
                f"{bits}-bit keys: device verifier and string verifier disagree"
            )
        if not h_res.mismatches:
            raise AssertionError(f"{bits}-bit keys seeded no mismatches")
        seconds["hashed_extract"] = time.perf_counter() - t
        log(f"{bits}-bit keys: {len(h_res.mismatches)} mismatches rejected, "
            f"{h_res.found} verified, device == string")

        t = time.perf_counter()
        collisions = collision_phase(store, bits, h_res.mismatches, log)
        seconds["collision_scan"] = time.perf_counter() - t
        t = time.perf_counter()
        baseline = baseline_phase(store, inter.ids, res.records,
                                  seconds["extract"], log)
        seconds["baseline"] = time.perf_counter() - t
        seconds["total"] = time.perf_counter() - t_all
        return {
            "device": str(dev),
            "records": spec.n_records,
            "corpus_bytes": manifest.total_bytes,
            "entries": len(idx),
            "intersection": inter.count,
            "extracted": res.found,
            "missing": len(res.missing),
            "mismatches": len(res.mismatches),
            "with_property": with_prop,
            "lookup_keys": len(keys),
            "lookup_stats": {
                k: (sorted(v) if isinstance(v, set) else v)
                for k, v in dataclasses.asdict(st_d).items()
            },
            "lookups_per_s": len(keys) / sec_d,
            "verified_per_s": res.verify_records / seconds["extract"],
            "verify_batches": res.verify_batches,
            "hashed_key_bits": bits,
            "hashed_mismatches": len(h_res.mismatches),
            "collisions": collisions,
            "baseline": baseline,
            "seconds": seconds,
        }
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--records", type=int, default=16_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(run_funnel(args.records, seed=args.seed, device=args.device)))


if __name__ == "__main__":
    main()
