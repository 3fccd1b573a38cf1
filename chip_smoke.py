"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

1. Device: the card's name and power limit (``nvidia-smi``), then every CUDA
   source of the port built with nvcc (one process per source, all at once).
2. Kernels against their plain PyTorch versions, on the card, at the
   paper's scale: ``sorted_probe`` over a sorted 176,929,690-entry digest
   plane (PubChem's count) with 477,123 queries (ChEMBL ∩ eMolecules), of
   which 435,413 (the extracted count) are drawn from the plane, plus a
   24-bit table with duplicate runs; ``hash_mix`` over the 1,048,576 x 128
   verify batch that ``compare_ids_batch`` forms for 435,413 pairs.  Outputs
   must match bit for bit.  ``tanimoto`` top-k against its plain version,
   scores as raw float32 bits and rows exactly: ``pubchem``, a plane of
   176,929,690 random 1,024-bit fingerprints (22.6 GB, generated on the
   card in chunks) screened by 64 queries at k = 32; ``ties``, 4,194,304
   rows drawn from 4,096 distinct fingerprints, shuffled, screened by 256
   queries (rows of the plane, all-zero queries, random ones) at k = 1,
   32 and 1,024.  Prints each kernel's time, the plain version's, a
   PyTorch library call's where one computes the same function, and the
   least time the card could take (its bound).
3. The funnel end to end on the card through ``repro_torch.launch.funnel``
   (corpus, index, publish, intersect, lookup_batch, extract + verify) at
   100,000 records, plus an extraction through 17-bit hashed keys whose
   collisions the device verifier must reject as the string verifier does,
   with every kernel's launch count set to 0 just before
   and read just after: each kernel must have launched on that path.
4. The query service on the funnel's corpus and store through
   ``repro_torch.launch.serve_index`` on the card (2 replicas, 8 clients,
   2 s per arm): lookup mode with its ``svc.fetch == serial extract``
   parity gate, and similarity mode at k = 8 with its ``svc.similar ==
   per-query similar_batch(probe="host")`` gate (the card's kernel against
   the host's plain version).  Launch counts are set to 0 before the phase
   and read after it: ``sorted_probe``, ``hash_mix`` and ``tanimoto`` must
   each have launched there.
5. A ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the HBM3
# rate, and the 32-bit integer rate: half the 67e12 FP32 CUDA-core rate,
# since a Hopper SM has 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

PUBCHEM = 176_929_690      # table entries (the paper's PubChem count)
QUERIES = 477_123          # ChEMBL ∩ eMolecules
FROM_PLANE = 435_413       # of which present in PubChem (the extracted count)
DUP_TABLE = 1 << 22        # the duplicate-run case: 24-bit digests
VERIFY_ROWS = 1 << 20      # 2 x 435,413 rows bucketed to a power of two
VERIFY_LANES = 128         # 112 lanes (431-byte ids) bucketed
HASH_OPS_PER_LANE = 19     # integer ops per (row, lane) in hash_mix's loop
FUNNEL_RECORDS = 100_000   # 8 files x 12,500 records, about 207 MB of SDF
FP_WORDS = 32              # 1,024-bit fingerprints (the store's default)
SIM_QUERIES = 64           # pubchem case: a service batch of queries
SIM_K = 32                 # the service's similar_top_k
TIES_ROWS = 1 << 22        # ties case: 4,194,304 rows ...
TIES_DISTINCT = 4096       # ... drawn from 4,096 distinct fingerprints
TIES_QUERIES = 256
TIES_KS = (1, 32, 1024)
PLANE_CHUNK = 1 << 23      # rows generated (and counted) per step on the card
PLAIN_ELEMS = 1 << 26      # (query, row) pairs per block of the plain version
# __popc throughput of compute capability 9.0: 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
M32 = 0xFFFFFFFF
SIGN = -(2**63)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn):
    """``(fn(), device milliseconds of that one call)`` (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def popc_per_s() -> float:
    """The card's __popc rate: 16 per clock per SM, at its maximum SM clock
    (``nvidia-smi clocks.max.sm``) over all its SMs."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def keys_to_pairs(keys: torch.Tensor) -> torch.Tensor:
    """Sign-flipped int64 keys → ``(N, 2)`` uint32 ``(hi, lo)`` pairs."""
    from repro_torch.kernels.hash_mix.ref import to_u32

    u = keys ^ SIGN
    return to_u32(torch.stack([(u >> 32) & M32, u & M32], dim=1)).contiguous()


def search_sectors(keys: torch.Tensor, qk: torch.Tensor) -> int:
    """Distinct 32-byte table sectors a lower-bound search of ``qk`` reads.

    Replays the kernel's branch-free search (the step widths do not depend
    on the data, only the bases do) and counts the sectors it touches.
    """
    m = keys.numel()
    base = torch.zeros_like(qk)
    length = m
    touched = []
    while length > 1:
        half = length >> 1
        idx = base + (half - 1)
        touched.append(idx)
        base = torch.where(keys[idx] < qk, base + half, base)
        length -= half
    touched.append(base)
    return int(torch.unique(torch.cat(touched) // 4).numel())


def probe_case(name, keys, qk, reps, note):
    """Hold sorted_probe's kernel to its plain version on one table."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

    table = keys_to_pairs(keys)
    queries = keys_to_pairs(qk)
    f_k, p_k = sorted_probe_cuda(queries, table)
    f_r, p_r = sorted_probe_ref(queries, table)
    torch.cuda.synchronize()
    if not (torch.equal(f_k, f_r) and torch.equal(p_k, p_r)):
        bad = int((f_k != f_r).sum() + (p_k != p_r).sum())
        fail(f"sorted_probe {name}: kernel disagrees with plain version ({bad} outputs)")
    err = int((p_k.to(torch.int64) - p_r.to(torch.int64)).abs().max())
    err = max(err, int((f_k != f_r).sum()))
    ms = cuda_ms(lambda: sorted_probe_cuda(queries, table), reps)
    plain = cuda_ms(lambda: sorted_probe_ref(queries, table), 3, warmup=1)
    library = cuda_ms(lambda: torch.searchsorted(keys, qk), reps)
    sectors = search_sectors(keys, qk)
    q = qk.numel()
    nbytes = sectors * 32 + q * 8 + q * (1 + 4)
    steps = max(1, (keys.numel() - 1).bit_length()) + 1
    b, by = bound_ms(nbytes, q * steps * 3)
    hits = int(f_k.sum())
    print(f"sorted_probe[{name}]: M={keys.numel()} Q={q} hits={hits} {note} "
          f"bit-exact; kernel_ms={ms:.6f} plain_ms={plain:.6f} "
          f"library_ms(searchsorted)={library:.6f} sectors={sectors} "
          f"bytes={nbytes} bound_ms={b:.6f} ({by})", flush=True)
    del table, queries
    return dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=b,
                bound_by=by, max_abs_err=err)


def random_u32(g, shape, dev) -> torch.Tensor:
    from repro_torch.kernels.hash_mix.ref import to_u32

    return to_u32(torch.randint(0, 2**32, shape, generator=g, device=dev,
                                dtype=torch.int64)).contiguous()


def tanimoto_case(name, q, db, dc, ks, reps, popc_rate):
    """Hold tanimoto's kernel to its plain version, bit for bit, at each k;
    time both at the first k."""
    from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
    from repro_torch.kernels.tanimoto.ref import row_counts, tanimoto_topk_ref

    qc = row_counts(q)
    n, w = db.shape
    nq = q.shape[0]
    chunk = max(1 << 16, PLAIN_ELEMS // nq)  # bounds the plain version's blocks
    out = None
    for k in ks:
        (s_k, i_k), ms = timed(lambda: tanimoto_topk_cuda(q, db, k, qc, dc))
        (s_r, i_r), plain = timed(
            lambda: tanimoto_topk_ref(q, db, k, qc, dc, db_chunk=chunk))
        bits_k, bits_r = s_k.view(torch.int32), s_r.view(torch.int32)
        if not (torch.equal(bits_k, bits_r) and torch.equal(i_k, i_r)):
            bad = int((bits_k != bits_r).sum() + (i_k != i_r).sum())
            fail(f"tanimoto {name} k={k}: kernel disagrees with plain version "
                 f"({bad} outputs)")
        err = float((s_k - s_r).abs().max())
        ties = int((s_k[:, 1:] == s_k[:, :-1]).sum()) if k > 1 else 0
        if out is None:
            ms = cuda_ms(lambda: tanimoto_topk_cuda(q, db, k, qc, dc), reps,
                         warmup=1)
            nbytes = n * (4 * w + 4) + nq * (4 * w + 4) + nq * k * 8
            ops = nq * n * w
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / popc_rate * 1e3
            b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            print(f"tanimoto[{name}]: N={n} W={w} Q={nq} k={k} bit-exact "
                  f"({ties} equal-score neighbours in the top-k); "
                  f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms=null "
                  f"bytes={nbytes} popcounts={ops} popc_per_s={popc_rate:.4g} "
                  f"bound_ms={b:.6f} ({by})", flush=True)
            out = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                       bound_by=by, max_abs_err=err)
        else:
            print(f"tanimoto[{name}]: k={k} bit-exact ({ties} equal-score "
                  f"neighbours); kernel_ms={ms:.6f} (one call) "
                  f"plain_ms={plain:.6f}", flush=True)
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del s_k, i_k, s_r, i_r, bits_k, bits_r
    return out


def tanimoto_phase(seed: int):
    """``pubchem`` and ``ties`` cases of the tanimoto kernel."""
    from repro_torch.kernels.tanimoto.ref import row_counts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    rate = popc_per_s()

    # -- pubchem: the plane at PubChem's row count, generated in chunks -----
    t0 = time.perf_counter()
    db = torch.empty((PUBCHEM, FP_WORDS), dtype=torch.uint32, device=dev)
    dc = torch.empty(PUBCHEM, dtype=torch.int32, device=dev)
    for lo in range(0, PUBCHEM, PLANE_CHUNK):
        hi = min(lo + PLANE_CHUNK, PUBCHEM)
        chunk = random_u32(g, (hi - lo, FP_WORDS), dev)
        db.view(torch.int32)[lo:hi].copy_(chunk.view(torch.int32))
        dc[lo:hi] = row_counts(chunk)
        del chunk
    q = random_u32(g, (SIM_QUERIES, FP_WORDS), dev)
    rows = torch.randint(0, PUBCHEM, (SIM_QUERIES // 4,), generator=g, device=dev)
    q.view(torch.int32)[: SIM_QUERIES // 4] = db.view(torch.int32)[rows]
    torch.cuda.synchronize()
    print(f"tanimoto[pubchem]: plane {PUBCHEM} x {FP_WORDS} words "
          f"({PUBCHEM * (4 * FP_WORDS + 4)} bytes) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    main = tanimoto_case("pubchem", q, db, dc, (SIM_K,), reps=3, popc_rate=rate)
    del db, dc, q, rows
    torch.cuda.empty_cache()

    # -- ties: 4,096 distinct fingerprints, each about 1,024 times ----------
    base = random_u32(g, (TIES_DISTINCT, FP_WORDS), dev)
    base.view(torch.int32)[0] = 0  # all-zero rows: u = 0 against zero queries
    pick = torch.randint(0, TIES_DISTINCT, (TIES_ROWS,), generator=g, device=dev)
    db = base.view(torch.int32)[pick].view(torch.uint32).contiguous()
    dc = row_counts(db)
    q = random_u32(g, (TIES_QUERIES, FP_WORDS), dev)
    qi = q.view(torch.int32)
    qi[: TIES_QUERIES // 2] = db.view(torch.int32)[
        torch.randint(0, TIES_ROWS, (TIES_QUERIES // 2,), generator=g, device=dev)]
    qi[TIES_QUERIES // 2: TIES_QUERIES // 2 + 16] = 0
    tanimoto_case("ties", q, db, dc, TIES_KS, reps=3, popc_rate=rate)
    del base, pick, db, dc, q, qi
    torch.cuda.empty_cache()
    return main


def kernel_phase(seed: int):
    from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
    from repro_torch.kernels.hash_mix.ref import hash_mix_ref, to_u32

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand_keys(n, bits=32):
        halves = torch.randint(0, 2**bits, (n, 2), generator=g, device=dev,
                               dtype=torch.int64)
        return ((halves[:, 0] << 32) | halves[:, 1]) ^ SIGN

    # -- sorted_probe at PubChem scale ---------------------------------------
    keys = torch.sort(rand_keys(PUBCHEM)).values
    pick = torch.randint(0, PUBCHEM, (FROM_PLANE,), generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(QUERIES - FROM_PLANE)])
    qk = qk[torch.randperm(QUERIES, generator=g, device=dev)]
    main = probe_case("pubchem", keys, qk, reps=50, note="(1.42 GB plane)")
    del keys, pick, qk

    # -- sorted_probe on 24-bit digests: duplicate runs -----------------------
    narrow = torch.randint(0, 1 << 24, (DUP_TABLE,), generator=g, device=dev)
    keys = torch.sort(narrow ^ SIGN).values  # hi = 0, lo = 24-bit digest
    runs = DUP_TABLE - int(torch.unique(keys).numel())
    if runs == 0:
        fail("24-bit table has no duplicate runs")
    pick = torch.randint(0, DUP_TABLE, (FROM_PLANE,), generator=g, device=dev)
    miss = torch.randint(0, 1 << 24, (QUERIES - FROM_PLANE,), generator=g,
                         device=dev) ^ SIGN
    qk = torch.cat([keys[pick], miss])
    probe_case("dup24", keys, qk, reps=50, note=f"({runs} duplicate entries)")
    del keys, narrow, pick, miss, qk

    # -- hash_mix on the verify batch -----------------------------------------
    x = to_u32(torch.randint(0, 2**32, (VERIFY_ROWS, VERIFY_LANES), generator=g,
                             device=dev, dtype=torch.int64)).contiguous()
    out_k = hash_mix_cuda(x)
    out_r = hash_mix_ref(x)
    torch.cuda.synchronize()
    a = out_k.view(torch.int32).to(torch.int64) & M32
    b = out_r.view(torch.int32).to(torch.int64) & M32
    err = int((a - b).abs().max())
    if err != 0:
        fail(f"hash_mix kernel disagrees with plain version (max_abs_err {err})")
    ms = cuda_ms(lambda: hash_mix_cuda(x), 20)
    plain = cuda_ms(lambda: hash_mix_ref(x), 2, warmup=1)
    nbytes = VERIFY_ROWS * VERIFY_LANES * 4 + VERIFY_ROWS * 16
    ops = VERIFY_ROWS * VERIFY_LANES * HASH_OPS_PER_LANE
    bnd, by = bound_ms(nbytes, ops)
    print(f"hash_mix: N={VERIFY_ROWS} W={VERIFY_LANES} bit-exact; "
          f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms=null "
          f"bytes={nbytes} ops={ops} bound_ms={bnd:.6f} ({by})", flush=True)
    hm = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
              bound_by=by, max_abs_err=err)
    del x, out_k, out_r, a, b
    torch.cuda.empty_cache()
    return main, hm


def serving_phase(serve_index, work: Path, wrappers, card: str):
    """The query service on the funnel's corpus and store, lookup mode then
    similarity mode; returns each kernel's launches over the phase."""
    common = ["--store", str(work / "store"), "--corpus", str(work / "corpus"),
              "--device", "cuda", "--replicas", "2", "--clients", "8",
              "--seconds", "2"]
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    look = serve_index.run(serve_index.build_parser().parse_args(common))
    sim = serve_index.run(serve_index.build_parser().parse_args(
        common + ["--similarity", "--similar-k", "8"]))
    launches = {n: fn.launches for n, fn in wrappers.items()}
    print(f"serving phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(launches)}", flush=True)
    for mode, out in (("lookup", look), ("similarity", sim)):
        if not out.get("parity"):
            fail(f"serve_index {mode} mode ran no parity gate")
        for arm in ("service", "naive"):
            r = out[arm]
            if r["errors"]:
                fail(f"serve_index {mode} {arm}: {r['errors']} requests raised")
            unit = "lookups/s" if mode == "lookup" else "similarity queries/s"
            print(f"serve_index[{mode}] {arm}: {r['per_s']:.1f} {unit}, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
                  f"{r['requests']} requests; card: {card}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched in the serving phase")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
        from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
        from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
        from repro_torch.launch import serve_index
        from repro_torch.launch.funnel import run_funnel
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    secs = build.build()
    print(f"build: {len(build.SOURCES)} sources in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    probe, hm = kernel_phase(args.seed)
    tani = tanimoto_phase(args.seed)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)

    wrappers = {"sorted_probe": sorted_probe_cuda, "hash_mix": hash_mix_cuda,
                "tanimoto": tanimoto_topk_cuda}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        for fn in wrappers.values():
            fn.launches = 0
        summary = run_funnel(FUNNEL_RECORDS, seed=args.seed, device="cuda",
                             log=lambda s: print(f"funnel: {s}", flush=True),
                             workdir=work)
        funnel_launches = {n: wrappers[n].launches
                           for n in ("sorted_probe", "hash_mix")}
        print(f"funnel summary: {json.dumps(summary)}", flush=True)
        for name, n in funnel_launches.items():
            if n == 0:
                fail(f"{name} was not launched on the funnel's path")
        print(f"funnel launches: {json.dumps(funnel_launches)}", flush=True)

        launches = serving_phase(serve_index, Path(work), wrappers, card)

    kernels = [
        dict(name="sorted_probe", route="cuda",
             source="src/repro_torch/csrc/sorted_probe.cu",
             replaces="src/repro/kernels/sorted_probe/kernel.py:53",
             launches=launches["sorted_probe"], **probe),
        dict(name="hash_mix", route="cuda",
             source="src/repro_torch/csrc/hash_mix.cu",
             replaces="src/repro/kernels/hash_mix/kernel.py:65",
             launches=launches["hash_mix"], **hm),
        dict(name="tanimoto", route="cuda",
             source="src/repro_torch/csrc/tanimoto.cu",
             replaces="src/repro/kernels/tanimoto/kernel.py:135",
             launches=launches["tanimoto"], **tani),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels]}))
    print(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
