"""The control runs that set a cell's limits, on the chip at the cell's own
size: for each seed, one run of the cell (a short window at its own load)
whose output is judged by the harness's own comparison twice or more:
the program's, and each stand-in's that the cell's driver puts in the
program's place (serving: the tokens that the reference at float8
weights chooses at the served positions; training: the reference at
float8, the fault that leaves half of each batch out, and the state left
unchanged).  Each side's ``correct`` comes from the same limits
(``bench/cells/<workload>.json``); every stand-in's has to come out false.
One JSON line a seed, all seeds in one process; the exit code is 0 only
where every program run was correct and every stand-in was not.

    python bench/control.py --workload yi6b-chat --seeds 11,12,13 --seconds 10
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import harness

ROOT = Path(__file__).resolve().parents[1]


def runs(workload: str, seeds: List[int], seconds: float, root: Path = ROOT,
         device=None, bench: Optional[Path] = None) -> Iterator[Dict]:
    """One line a seed: each side's ``correct`` and compared numbers, and
    the run's own end-to-end metrics and window."""
    for seed in seeds:
        t0 = time.perf_counter()
        res = harness.run_cell(workload, seed, seconds, False, t0, root, device=device,
                               control=True, bench=bench)
        if res is None:
            raise SystemExit(1)
        yield {"workload": workload, "seed": seed, "sides": res["control"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "window": res["window"],
               "memory_peak_bytes": res["device"]["memory_peak_bytes"],
               "wall_s": time.perf_counter() - t0}


def separated(line: Dict) -> bool:
    """The program's run is correct, and no stand-in is."""
    return all(side["correct"] == (name == "program") for name, side in line["sides"].items())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    harness.environment(ROOT)
    ok = True
    for line in runs(args.workload, [int(s) for s in args.seeds.split(",")], args.seconds):
        print(json.dumps(line), flush=True)
        for name, side in line["sides"].items():
            print(f"seed {line['seed']} {name}: correct {side['correct']}, "
                  + ", ".join(f"{k} {v['value']!r} (limit {v['limit']!r})"
                              for k, v in side["compared"].items()), file=sys.stderr)
        ok = ok and separated(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
