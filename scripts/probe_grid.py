"""Time ``sorted_probe`` against ``torch.searchsorted`` on one CUDA card,
over the shapes the system sends and beyond, and the wrapper at a serving
request's shape.

    python3 scripts/probe_grid.py [--src DIR] [--grid] [--out FILE]

* Serving shape (always): ``sorted_probe_cuda``, the wrapper as the
  service calls it (checks, launch, count), on 32 keys in a sorted
  100,000-row table, and ``torch.searchsorted`` on the same keys: the
  host's microseconds per call (10,000 calls, then one synchronize), the
  device's milliseconds per call with the calls queued behind a sleep (so
  the host's enqueue time is hidden), and cold (L2 flushed before each
  call, each call timed alone).  ``--src`` names the ``src`` directory
  whose ``repro_torch`` is timed (default: this checkout's), so that two
  checkouts can be compared in one run on one card.
* ``--grid``: the wrapper and ``torch.searchsorted`` over a grid of table
  rows M and queries Q, from the funnel's per-shard probe to PubChem's
  whole plane, the kernel first held to the plain version bit for bit.
  Device times, queued and cold as above.

Prints one line per measurement and the card's name and power limit, and
writes every number to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402  (the same timers and shapes)
    HOST_CALLS, L2_FLUSH_BYTES, SERVE_KEYS, SERVE_PLANE, SIGN, cold_ms,
    host_us, keys_to_pairs, queued_ms)

# (M, Q): the funnel's per-shard probe at 100,000 records (16 shards), the
# service's plane at that size, PubChem's plane split into 16 shards
# (176,929,690 / 16 rows, 477,123 / 16 keys) and whole, and powers of two
ROWS = (6_250, 100_000, 1 << 17, 1 << 20, 11_058_106, 1 << 24, 176_929_690)
QUERIES = (32, 512, 2_048, 6_375, 29_820, 67_584, 131_072, 477_123)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--grid", action="store_true")
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
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

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
    wrapper = lambda: sp.sorted_probe_cuda(queries, table)  # noqa: E731
    library = lambda: torch.searchsorted(keys, qk)  # noqa: E731
    for name, fn in (("wrapper", wrapper), ("searchsorted", library)):
        row = dict(host_us=host_us(fn, HOST_CALLS), queued_ms=queued_ms(fn, 200),
                   cold_ms=cold_ms(fn, 50, flush))
        out["serving"][name] = row
        print(f"serving[{name}]: M={SERVE_PLANE} Q={SERVE_KEYS} "
              f"host_us={row['host_us']:.3f} queued_ms={row['queued_ms']:.6f} "
              f"cold_ms={row['cold_ms']:.6f}", flush=True)
    del keys, qk, table, queries

    if args.grid:
        for m in ROWS:
            keys = torch.sort(rand_keys(m)).values
            table = keys_to_pairs(keys)
            for q in QUERIES:
                qk = draw(keys, q)
                queries = keys_to_pairs(qk)
                found, pos = sp.sorted_probe_cuda(queries, table)
                f_r, p_r = sorted_probe_ref(queries, table)
                if not (torch.equal(found, f_r) and torch.equal(pos, p_r)):
                    sys.exit(f"probe_grid: kernel disagrees with plain version at M={m} Q={q}")
                kernel = lambda: sp.sorted_probe_cuda(queries, table)  # noqa: E731
                lib = lambda: torch.searchsorted(keys, qk)  # noqa: E731
                row = dict(m=m, q=q, kernel_queued_ms=queued_ms(kernel, 20),
                           kernel_cold_ms=cold_ms(kernel, 10, flush),
                           searchsorted_queued_ms=queued_ms(lib, 20),
                           searchsorted_cold_ms=cold_ms(lib, 10, flush))
                out["grid"].append(row)
                print("grid: " + " ".join(
                    f"{k}={v:.6f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()), flush=True)
                del qk, queries, found, pos, f_r, p_r
            del keys, table
            torch.cuda.empty_cache()

    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(f"nvidia-smi: {card}; wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
