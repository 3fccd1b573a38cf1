"""Time the ``tanimoto`` kernel on one CUDA card at ``chip_smoke.py``'s
shapes, as built and with one piece of its design changed.

    python3 scripts/tanimoto_variants.py [--src DIR] [--variants A,B,...]
                                         [--skip CASE,...] [--out FILE]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two checkouts can be compared in one
run on one card.  ``--variants`` (default ``built``): ``built`` is the
wrapper as the package builds it; every other name compiles a copy of
``csrc/tanimoto.cu`` with one text edit (``EDITS``) and points the
wrapper at it, or changes one field of ``plan()`` (``PLANS``).  Every
variant is held to the built kernel's output bit for bit at each case.

Cases (``chip_smoke.py``'s): ``pubchem`` k = 32 and 1,024 (176,929,690
random rows, 64 queries), ``ties`` k = 32, 1,024 and 2,048 (4,194,304 rows
of 4,096 fingerprints, 256 queries), ``ties-pads`` (its first 5,000 rows,
k = 8,192), ``served`` k = 8, 32 and 1,024 (100,000 rows, 4 queries,
queued behind a sleep).  Device milliseconds per call (CUDA events, warm);
prints one line per measurement and the card's name and power limit, and
writes every number to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402  (the same timers and shapes)
    FP_WORDS, PADS_K, PADS_ROWS, PLANE_CHUNK, PUBCHEM, SERVE_KS,
    SERVE_PLANE, SERVE_QUERIES, SIM_QUERIES, TIES_DISTINCT, TIES_QUERIES,
    TIES_ROWS, cuda_ms, queued_ms, random_u32)

# name -> (text in csrc/tanimoto.cu, its replacement)
EDITS = {
    # one warp folds each query whatever the queries a block
    "one-warp-fold": ("const int team_lg = nql > 4 ? 0 : nql > 2 ? 1 : nql > 1 ? 2 : 3;",
                      "const int team_lg = 0;"),
    # publish the threshold, read the others' back only every kRefresh rounds
    "no-read-back": ("const u64 seen = kth > 0 ? atomicMax(tau_g + q0 + team, kth)\n"
                     "                               : atomicAdd(tau_g + q0 + team, 0ull);",
                     "if (kth > 0) atomicMax(tau_g + q0 + team, kth);\n"
                     "      const u64 seen = 0;"),
    # a loop of dependent 16-byte row loads in place of all 8 at once
    "loop-loads": ("const int w4 = !vec4 ? -1 : w == 32 ? 8 : 0;",
                   "const int w4 = !vec4 ? -1 : 0;"),
    # every filter instance on the default-bounds kernel (the parent's:
    # ptxas spills a register in <1, -1> and <2, 0>)
    "no-wide": ("constexpr bool kWideFilter = (QPB == 1 && W4 == -1) || (QPB == 2 && W4 == 0);",
                "constexpr bool kWideFilter = false;"),
}
# name -> plan fields replaced for the filter route
PLANS = {"fresh-512": {"fresh": 512}}


def compile_edit(src: Path, name: str, build) -> ctypes._CFuncPtr:
    old, new = EDITS[name]
    text = (src / "repro_torch" / "csrc" / "tanimoto.cu").read_text()
    if old not in text:
        raise SystemExit(f"tanimoto_variants: edit {name} does not apply to {src}")
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"lib{name}.so"
    cu.write_text(text.replace(old, new))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so)).tanimoto_topk_launch


def cases(seed: int, skip):
    """(name, queries, plane, plane counts, ks, served) of each case."""
    from repro_torch.kernels.tanimoto.ref import row_counts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    if not {"pubchem"} <= skip:
        db = torch.empty((PUBCHEM, FP_WORDS), dtype=torch.uint32, device=dev)
        dc = torch.empty(PUBCHEM, dtype=torch.int32, device=dev)
        for lo in range(0, PUBCHEM, PLANE_CHUNK):
            chunk = random_u32(g, (min(PLANE_CHUNK, PUBCHEM - lo), FP_WORDS), dev)
            db.view(torch.int32)[lo:lo + len(chunk)].copy_(chunk.view(torch.int32))
            dc[lo:lo + len(chunk)] = row_counts(chunk)
        q = random_u32(g, (SIM_QUERIES, FP_WORDS), dev)
        ks = (32,) if "pubchem-1024" in skip else (32, 1024)
        yield "pubchem", q, db, dc, ks, False
        del db, dc
        torch.cuda.empty_cache()
    base = random_u32(g, (TIES_DISTINCT, FP_WORDS), dev)
    base.view(torch.int32)[0] = 0
    pick = torch.randint(0, TIES_DISTINCT, (TIES_ROWS,), generator=g, device=dev)
    db = base.view(torch.int32)[pick].view(torch.uint32).contiguous()
    dc = row_counts(db)
    q = random_u32(g, (TIES_QUERIES, FP_WORDS), dev)
    q.view(torch.int32)[: TIES_QUERIES // 2] = db.view(torch.int32)[
        torch.randint(0, TIES_ROWS, (TIES_QUERIES // 2,), generator=g, device=dev)]
    q.view(torch.int32)[TIES_QUERIES // 2: TIES_QUERIES // 2 + 16] = 0
    yield "ties", q, db, dc, (32, 1024, 2048), False
    yield "ties-pads", q, db[:PADS_ROWS].contiguous(), dc[:PADS_ROWS].contiguous(), (PADS_K,), False
    db = random_u32(g, (SERVE_PLANE, FP_WORDS), dev)
    q = random_u32(g, (SERVE_QUERIES, FP_WORDS), dev)
    q.view(torch.int32)[: SERVE_QUERIES // 2] = db.view(torch.int32)[: SERVE_QUERIES // 2]
    yield "served", q, db, row_counts(db), SERVE_KS, True


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--variants", default="built")
    ap.add_argument("--skip", default="", help="pubchem, pubchem-1024")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "tanimoto_variants.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("tanimoto_variants: needs a CUDA card")
    # chip_smoke imported this checkout's package: time the one in --src
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(args.src.resolve()))
    K = importlib.import_module("repro_torch.kernels.tanimoto.kernel")
    from repro_torch.kernels import build
    from repro_torch.kernels.tanimoto.ref import row_counts

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src {args.src}", flush=True)
    built_fn, built_plan = K._fn(), K.plan
    fns = {}
    for name in args.variants.split(","):
        if name in EDITS:
            f = compile_edit(args.src.resolve(), name, build)
            f.argtypes, f.restype = built_fn.argtypes, built_fn.restype
            fns[name] = (f, built_plan)
        elif name in PLANS:
            fields = PLANS[name]
            fns[name] = (built_fn, lambda *a, _f=fields: (
                lambda p: p._replace(**_f) if p.route == "filter" else p)(built_plan(*a)))
        elif name == "built":
            fns[name] = (built_fn, built_plan)
        else:
            sys.exit(f"tanimoto_variants: unknown variant {name}")
    results = []
    for case, q, db, dc, ks, served in cases(args.seed, set(filter(None, args.skip.split(",")))):
        qc = row_counts(q)
        for k in ks:
            want = None
            for name, (fn, pl) in fns.items():
                K._FN, K.plan = fn, pl
                kernel = lambda: K.tanimoto_topk_cuda(q, db, k, qc, dc)  # noqa: E731
                s, i = kernel()
                if want is None:
                    want = (s.view(torch.int32).clone(), i.clone())
                elif not (torch.equal(s.view(torch.int32), want[0]) and torch.equal(i, want[1])):
                    sys.exit(f"tanimoto_variants: {name} disagrees at {case} k={k}")
                ms = queued_ms(kernel, 100) if served else cuda_ms(kernel, 3, warmup=1)
                # an older checkout's plan() returns a tuple and has no routes
                route = getattr(pl(q.shape[0], db.shape[0], db.shape[1], k), "route", None)
                print(f"tanimoto[{case}] k={k} {name}: kernel_ms={ms:.6f} "
                      f"({'queued' if served else 'warm'}) route={route}", flush=True)
                results.append(dict(case=case, k=k, variant=name, ms=ms, route=route))
            K._FN, K.plan = built_fn, built_plan
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, src=str(args.src), results=results), indent=1))
    print(f"nvidia-smi: {card}")


if __name__ == "__main__":
    main()
