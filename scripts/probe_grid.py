"""Time ``sorted_probe`` against ``torch.searchsorted`` on one CUDA card,
over the shapes the system sends and beyond, and the served call's host
time at a serving request.

    python3 scripts/probe_grid.py [--src DIR] [--grid]
                                  [--variants built,nodes16,l2-hints] [--out FILE]

* Serving shape (always): ``sorted_probe_cuda``, the wrapper as the
  service calls it (on the store's ``ProbeTable`` where the package has
  one, else on the plain tensor), on 32 keys in a sorted 100,000-row
  table, and ``torch.searchsorted`` on the same keys: the host's
  microseconds per call (10,000 calls, then one synchronize), the device's
  milliseconds per call with the calls queued behind a sleep (so the
  host's enqueue time is hidden), and cold (L2 flushed before each call,
  each call timed alone).  Then the store's whole served probe,
  ``core/store.py`` ``_probe_starts_device`` (numpy digests in, numpy
  results out), on the host's clock.  ``--src`` names the ``src``
  directory whose ``repro_torch`` is timed (default: this checkout's), so
  that two checkouts can be compared in one run on one card.
* ``--grid``: over a grid of table rows M and queries Q, from the funnel's
  per-shard probe to PubChem's whole plane, the wrapper on the route the
  table takes (printed), then, where the package has routes, both routes
  forced through ``kernel.launch`` (a direct-route table given fences built
  for it), and ``torch.searchsorted``; each kernel first held to the plain
  version bit for bit.  Device times, queued and cold as above.  The line between the
  routes (``kernel.py`` ``FENCED_MIN_ROWS``) is read from this grid.
* ``--variants``: ``built`` is the kernel as the package builds it; every
  other name compiles a copy of ``csrc/sorted_probe.cu`` with one text
  edit (``EDITS``) and times its fenced kernel at each grid point beside
  the built one (bit for bit against the plain version first), over
  fences built for the variant's node size (``VARIANT_NODE_KEYS``).

Prints one line per measurement and the card's name and power limit, and
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

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402  (the same timers and shapes)
    HOST_CALLS, L2_FLUSH_BYTES, SERVE_KEYS, SERVE_PLANE, SIGN, cold_ms,
    host_us, keys_to_pairs, queued_ms)

# (M, Q): the funnel's per-shard probe at 100,000 records (16 shards), the
# service's plane at that size, powers of two around the card's 50 MB L2,
# PubChem's plane split into 16 shards (176,929,690 / 16 rows, 477,123 / 16
# keys: PERF.md row 2c) and whole
ROWS = (6_250, 100_000, 1 << 17, 1 << 20, 1 << 22, 1 << 23, 11_058_106,
        1 << 24, 176_929_690)
QUERIES = (32, 512, 2_048, 6_375, 29_820, 67_584, 131_072, 477_123)

_HINTED = (
    "uint4 {v};\n"
    "  {{ uint64_t pol;\n"
    '    asm volatile("createpolicy.fractional.L2::{policy}.b64 %0, 1.0;" : "=l"(pol));\n'
    '    asm("ld.global.nc.L2::cache_hint.v4.u32 {{%0, %1, %2, %3}}, [%4], %5;"\n'
    '        : "=r"({v}.x), "=r"({v}.y), "=r"({v}.z), "=r"({v}.w) : "l"({ptr}), "l"(pol)); }}')
# name -> [(text in csrc/sorted_probe.cu, its replacement), ...]
EDITS = {
    # nodes and leaf lines of 16 keys (128 bytes, 8 lanes a query):
    # measured slower than 8 at PubChem's probe, not kept
    "nodes16": [("constexpr int kNodeKeys = 8;", "constexpr int kNodeKeys = 16;")],
    # fence reads with an L2 evict_last policy and leaf reads evict_first
    # (createpolicy + ld.global.nc.L2::cache_hint): measured, not kept
    "l2-hints": [
        ("const uint4 v = __ldg(fences + (lv.off[l] + node * B) / 2 + sub);",
         _HINTED.format(v="v", policy="evict_last",
                        ptr="fences + (lv.off[l] + node * B) / 2 + sub")),
        ("const uint4 v = __ldg(reinterpret_cast<const uint4*>(table) + i0 / 2);",
         _HINTED.format(v="v", policy="evict_first",
                        ptr="reinterpret_cast<const uint4*>(table) + i0 / 2")),
    ],
}
# the node size a variant's fences are built with (kernel.py NODE_KEYS else)
VARIANT_NODE_KEYS = {"nodes16": 16}


def variant_table(sp, table, name):
    """A ``ProbeTable`` of ``table`` with fences built for variant ``name``'s
    node size, the package's ``NODE_KEYS`` set to it for the build."""
    saved = sp.NODE_KEYS
    sp.NODE_KEYS = VARIANT_NODE_KEYS.get(name, saved)
    try:
        return sp.ProbeTable(table, fences=sp.build_fences(table))
    finally:
        sp.NODE_KEYS = saved


def compile_edit(src: Path, name: str, build):
    text = (src / "repro_torch" / "csrc" / "sorted_probe.cu").read_text()
    for old, new in EDITS[name]:
        if old not in text:
            raise SystemExit(f"probe_grid: edit {name} does not apply to {src}")
        text = text.replace(old, new)
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"probe-{name}.cu", out / f"libprobe-{name}.so"
    cu.write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so)).sorted_probe_launch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--grid", action="store_true")
    ap.add_argument("--variants", default="built")
    ap.add_argument("--rows", default="", help="comma-separated M of the grid")
    ap.add_argument("--queries", default="", help="comma-separated Q of the grid")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "probe_grid.json")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_grid: needs a CUDA card")
    # chip_smoke imported this checkout's package: time the one in --src
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(args.src.resolve()))  # ahead of this checkout's src
    sp = importlib.import_module("repro_torch.kernels.sorted_probe.kernel")
    store = importlib.import_module("repro_torch.core.store")
    from repro_torch.kernels import build
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

    fenced = hasattr(sp, "ProbeTable")  # an older checkout has one kernel
    wrap = sp.ProbeTable if fenced else (lambda t: t)
    variants = {}
    for name in args.variants.split(","):
        if name == "built" or not fenced:
            continue
        f = compile_edit(args.src.resolve(), name, build)
        built = sp._fn("sorted_probe_launch")
        f.argtypes, f.restype = built.argtypes, built.restype
        variants[name] = f
    rows = tuple(int(x) for x in args.rows.split(",")) if args.rows else ROWS
    qs = tuple(int(x) for x in args.queries.split(",")) if args.queries else QUERIES

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def rand_keys(n):
        halves = torch.randint(0, 2**32, (n, 2), generator=g, device=dev,
                               dtype=torch.int64)
        return ((halves[:, 0] << 32) | halves[:, 1]) ^ SIGN

    def draw(keys, q):
        hit = q - q // 10  # nine in ten present
        pick = torch.randint(0, keys.numel(), (hit,), generator=g, device=dev)
        return torch.cat([keys[pick], rand_keys(q - hit)])

    out = {"card": card, "src": str(args.src), "serving": {}, "grid": []}
    print(f"card: {card}; src: {args.src}", flush=True)

    keys = torch.sort(rand_keys(SERVE_PLANE)).values
    qk = draw(keys, SERVE_KEYS)
    table, queries = keys_to_pairs(keys), keys_to_pairs(qk)
    pt = wrap(table)
    wrapper = lambda: sp.sorted_probe_cuda(queries, pt)  # noqa: E731
    library = lambda: torch.searchsorted(keys, qk)  # noqa: E731
    for name, fn in (("wrapper", wrapper), ("searchsorted", library)):
        row = dict(host_us=host_us(fn, HOST_CALLS), queued_ms=queued_ms(fn, 200),
                   cold_ms=cold_ms(fn, 50, flush))
        out["serving"][name] = row
        print(f"serving[{name}]: M={SERVE_PLANE} Q={SERVE_KEYS} "
              f"route={getattr(pt, 'route', 'direct')} "
              f"host_us={row['host_us']:.3f} queued_ms={row['queued_ms']:.6f} "
              f"cold_ms={row['cold_ms']:.6f}", flush=True)
    digests = (qk ^ SIGN).cpu().numpy().view(np.uint64)
    served = lambda: store._probe_starts_device(pt, digests)  # noqa: E731
    found, starts = served()
    f_r, p_r = sorted_probe_ref(queries, table)
    if not (np.array_equal(found, f_r.cpu().numpy())
            and np.array_equal(starts, p_r.cpu().numpy())):
        sys.exit("probe_grid: the served probe disagrees with the plain version")
    out["serving"]["probe_starts_device_host_us"] = host_us(served, HOST_CALLS)
    print(f"serving[_probe_starts_device]: M={SERVE_PLANE} Q={SERVE_KEYS} "
          f"host_us={out['serving']['probe_starts_device_host_us']:.3f}", flush=True)
    del keys, qk, table, queries, pt

    def check(name, got, want, m, q):
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            sys.exit(f"probe_grid: {name} disagrees with plain version at M={m} Q={q}")

    if args.grid:
        for m in rows:
            keys = torch.sort(rand_keys(m)).values
            table = keys_to_pairs(keys)
            pt = sp.ProbeTable(table) if fenced else table
            path = getattr(pt, "route", "direct")
            # what both routes are forced on: the table's own fences, or
            # fences built for a direct-route table; and each variant's
            tables = {"": (pt if pt.fences is not None else variant_table(sp, table, ""))
                      } if fenced else {}
            tables.update((name, variant_table(sp, table, name)) for name in variants)
            for q in qs:
                qk = draw(keys, q)
                queries = keys_to_pairs(qk)
                want = sorted_probe_ref(queries, table)
                check("wrapper", sp.sorted_probe_cuda(queries, pt), want, m, q)
                kernel = lambda: sp.sorted_probe_cuda(queries, pt)  # noqa: E731
                lib = lambda: torch.searchsorted(keys, qk)  # noqa: E731
                row = dict(m=m, q=q, route=path, kernel_queued_ms=queued_ms(kernel, 20),
                           kernel_cold_ms=cold_ms(kernel, 10, flush))
                pos = torch.empty(q, dtype=torch.int32, device=dev)
                found = torch.empty(q, dtype=torch.bool, device=dev)
                forced = {}
                if fenced:
                    for other in sp.ROUTES:
                        forced[other] = (lambda other=other: sp.launch(
                            other, tables[""], queries, pos, found))
                for name, fn in variants.items():
                    def run(t=tables[name], fn=fn):
                        saved = sp._FNS["sorted_probe_launch"]
                        sp._FNS["sorted_probe_launch"] = fn
                        try:
                            sp.launch("fenced", t, queries, pos, found)
                        finally:
                            sp._FNS["sorted_probe_launch"] = saved
                    forced[f"fenced-{name}"] = run
                for name, fn in forced.items():
                    fn()
                    check(name, (found, pos), want, m, q)
                    row[f"{name}_queued_ms"] = queued_ms(fn, 20)
                    row[f"{name}_cold_ms"] = cold_ms(fn, 10, flush)
                row["searchsorted_queued_ms"] = queued_ms(lib, 20)
                row["searchsorted_cold_ms"] = cold_ms(lib, 10, flush)
                out["grid"].append(row)
                print("grid: " + " ".join(
                    f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()), flush=True)
                del qk, queries, want, pos, found
            del keys, table, tables, pt
            torch.cuda.empty_cache()

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"nvidia-smi: {card}; wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
