"""Run one cell of the benchmark once and print its result.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file, its traffic mix ``bench/mixes/<traffic>.json`` and the
driver that mix names (``bench/drivers/<driver>.py``), the family's plain
reference (``bench/reference/<family>.py``), the cell's limits
(``bench/cells/<workload>.json``) and, with ``--trace 1``, one reader a
per-layer metric (``bench/layer_metrics/<metric>.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced
runs) and, last, ``compared``: each number that decided ``correct`` with
its limit, also printed as the last lines of standard error.  Without a
card, with fewer cards than the cell asks for, or with a module of JAX or
of the JAX package loaded when the window has closed, it prints no result
and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.environment(ROOT)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_process=T_PROCESS, root=ROOT)
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
