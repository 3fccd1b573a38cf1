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
    build_index,
    extract,
    extract_property,
    intersect_host,
    intersect_sorted,
)
from ..core.sdfgen import (
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
        seconds["total"] = time.perf_counter() - t_all
        log(f"{bits}-bit keys: {len(h_res.mismatches)} mismatches rejected, "
            f"{h_res.found} verified, device == string")
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
