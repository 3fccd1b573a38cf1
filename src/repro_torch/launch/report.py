"""Render the dry-run's JSONL records as markdown tables (the reference's
``launch/report.py``, reading the port's records).

    python -m repro_torch.launch.report roofline runs/dryrun.jsonl [32x8]
    python -m repro_torch.launch.report compare base.jsonl opt.jsonl [32x8]

The port's records give the per-device argument bytes and no temporaries
(``launch/dryrun.py``), so the memory column reads "args+n/a".
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

from .roofline import HW

__all__ = ["compare_table", "roofline_table"]


def _gb(n) -> str:
    return "n/a" if n is None else f"{n / 1e9:.1f}"


def _mfu(rec) -> float:
    lb = rec["roofline"]["step_time_lb_s"]
    return rec["model_flops_per_device"] / (lb * HW.PEAK_FLOPS) if lb else 0.0


def roofline_table(path: Path, mesh: str = "32x8") -> str:
    rows = [json.loads(line) for line in open(path)]
    out = [
        "| arch × shape | bottleneck | t_comp (s) | t_mem (s) | t_coll (s) "
        "| MFU-bound | useful FLOPs | HBM args+temp (GB) |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        if r.get("mesh") != mesh:
            continue
        if r["status"] == "skipped":
            out.append(
                f"| {r['arch']} × {r['shape']} | — skipped (long_500k needs "
                f"sub-quadratic attention) | | | | | | |"
            )
            continue
        if r["status"] != "ok":
            out.append(f"| {r['arch']} × {r['shape']} | ERROR | | | | | | |")
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} × {r['shape']} | {rf['bottleneck']} "
            f"| {rf['t_compute_s']:.3f} | {rf['t_memory_s']:.3f} "
            f"| {rf['t_collective_s']:.3f} | {_mfu(r):.1%} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {_gb(r['arg_bytes_per_device'])}+{_gb(r['temp_bytes_per_device'])} |"
        )
    return "\n".join(out)


def compare_table(base_path: Path, opt_path: Path, mesh: str = "32x8") -> str:
    def load(p):
        return {
            (r["arch"], r["shape"]): r
            for r in map(json.loads, open(p))
            if r.get("mesh") == mesh and r["status"] == "ok"
        }

    base, opt = load(base_path), load(opt_path)
    out = [
        "| cell | t_mem base→opt | t_coll base→opt | args GB base→opt "
        "| MFU-bound base→opt |",
        "|---|---|---|---|---|",
    ]
    for key in base:
        if key not in opt:
            continue
        b, o = base[key], opt[key]
        rb, ro = b["roofline"], o["roofline"]
        out.append(
            f"| {key[0]} × {key[1]} "
            f"| {rb['t_memory_s']:.2f}→{ro['t_memory_s']:.2f} "
            f"| {rb['t_collective_s']:.2f}→{ro['t_collective_s']:.2f} "
            f"| {_gb(b['arg_bytes_per_device'])}→{_gb(o['arg_bytes_per_device'])} "
            f"| {_mfu(b):.1%}→{_mfu(o):.1%} |"
        )
    return "\n".join(out)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cmd = argv[0]
    if cmd == "roofline":
        print(roofline_table(Path(argv[1]), argv[2] if len(argv) > 2 else "32x8"))
    elif cmd == "compare":
        print(compare_table(Path(argv[1]), Path(argv[2]),
                            argv[3] if len(argv) > 3 else "32x8"))
    else:
        raise SystemExit(f"unknown command {cmd!r} (roofline or compare)")


if __name__ == "__main__":
    main()
