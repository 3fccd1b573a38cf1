"""The harness behind ``bench/run.py``: finds a cell's files by name, runs
its driver, checks what the timed path produced against the plain
reference, reads the per-layer metrics of a traced run, and assembles the
result line."""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent

# top-level modules a run must not have loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["FORBIDDEN", "environment", "forbidden_modules", "judge", "load_cell", "run_cell"]


def environment(root: Path) -> None:
    """Before torch loads: every build and kernel cache in a fixed directory
    inside the checkout, and libraries kept from loading JAX."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(Path(root) / ".bench_cache" / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``,
    names compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _json(path: Path) -> Dict:
    return json.loads(Path(path).read_text())


def _module(path: Path):
    """A module loaded from ``path`` (a file name may hold dots)."""
    name = "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _find(items: List[Dict], name: str, what: str) -> Dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(workload: str, root: Path, bench: Optional[Path] = None,
              overrides: Optional[Dict] = None) -> SimpleNamespace:
    """Everything of one cell, found by name: ``benchmark`` (the parsed
    ``BENCHMARK.json`` of ``root``), ``cell``, ``config`` (its file),
    ``mix`` (``mixes/<traffic>.json``), ``limits`` (``cells/<workload>.json``),
    ``driver`` (``drivers/<mix driver>.py``), ``ref`` (``reference/<family>.py``)
    and the ``end_to_end`` and ``per_layer`` metrics this cell reports."""
    bench = Path(bench) if bench is not None else BENCH
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    spec = _json(Path(root) / "BENCHMARK.json")
    cell = _find(spec["workloads"], workload, "workload")
    conf = _find(spec["configs"], cell["config"], "config")
    config = dict(_json(Path(root) / conf["file"]), **(overrides or {}))
    mix = _json(bench / "mixes" / f"{cell['traffic']}.json")

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        benchmark=spec, cell=cell, config=config, mix=mix,
        limits=_json(bench / "cells" / f"{workload}.json"),
        driver=_module(bench / "drivers" / f"{mix['driver']}.py"),
        ref=importlib.import_module(f"reference.{config['family']}"),
        end_to_end=[m for m in spec["end_to_end"] if mine(m)],
        per_layer=[m for m in spec["per_layer"] if mine(m)],
        readers={m["name"]: bench / "layer_metrics" / f"{m['name']}.py"
                 for m in spec["per_layer"] if mine(m)},
    )


def _cards(chips: int):
    """The first card, or None (and why, on standard error) where there
    are fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def _breakdown(rec: Dict) -> Dict:
    """The 10 device operations that took most time in the traced window,
    and its 10 longest idle gaps by the host span they fall in."""
    import profiling

    lo, hi = rec["window"]
    per: Dict[str, float] = {}
    for name, a, b in rec["device"]:
        if lo <= a < hi:
            per[name] = per.get(name, 0.0) + (min(b, hi) - a) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    spans = sorted((a, b, n) for n, v in rec["spans"].items() if n != "bench.window"
                   for a, b in v)

    def where(t: float) -> str:
        best = "host, outside the program's spans"
        for a, b, n in spans:
            if a <= t < b:
                best = n
        return best

    gaps = sorted(profiling.idle_gaps(rec), key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[where((a + b) / 2), (b - a) / 1e6] for a, b in gaps]}


def judge(readings: Dict, limits: Dict, out: Dict):
    """``(compared, correct)`` of one side's readings (the program's, or a
    stand-in's put in its place): each number under its limit, in a run
    that attempted work and failed none."""
    compared = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    correct = bool(out["attempted"] > 0 and out["failed"] == 0
                   and all(v["value"] <= v["limit"] for v in compared.values()))
    return compared, correct


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
             root: Path, device=None, control: bool = False,
             bench: Optional[Path] = None, overrides: Optional[Dict] = None) -> Optional[Dict]:
    """One run of ``workload``: the result line's object, or None where the
    run may print no result.  ``device`` None asks for the cell's cards;
    tests pass the CPU.  ``control`` also judges each stand-in that the
    driver puts in the program's place (``result["control"]``), by the
    same limits as the program;
    ``overrides`` replaces fields of the configuration file (a witness
    run, such as the program in float32)."""
    cell = load_cell(workload, root, bench, overrides)
    if device is None:
        device = _cards(cell.cell["chips"])
        if device is None:
            return None
    if "remat" in cell.mix:     # read by the program's flags at import
        os.environ["REPRO_REMAT_POLICY"] = cell.mix["remat"]
    src = str(Path(root) / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch

    import program
    from reference.common import set_plain_f32
    from traffic import Traffic

    device = torch.device(device)
    setup = {}
    phases = [("imports", time.perf_counter() - t_process)]
    ctx = SimpleNamespace(
        seed=seed, seconds=seconds, trace=trace, device=device, cell=cell.cell,
        config=cell.config, mix=cell.mix, ref=cell.ref, now=time.perf_counter,
        trace_seconds=min(seconds, cell.mix.get("trace_seconds", seconds)),
        traffic=Traffic(cell.mix, seed) if "prompt" in cell.mix else None,
        mark_setup=lambda: setup.setdefault("s", time.perf_counter() - t_process),
        phase=lambda name: phases.append((name, time.perf_counter() - t_process)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.zeros((1,), device=device)      # the context, before its counters
        torch.cuda.reset_peak_memory_stats()
    ctx.phase("cuda")
    ctx.origin = program.mark(device)
    out = cell.driver.run(ctx)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    set_plain_f32()
    sides = cell.driver.check(ctx, out, control)
    judged = {name: judge(r, cell.limits, out) for name, r in sides.items()}
    compared, correct = judged["program"]

    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return None
    print("imports: no module of jax, jaxlib, flax or repro is loaded", file=sys.stderr)

    units = {m["name"]: m["unit"] for m in cell.benchmark["end_to_end"] + cell.benchmark["per_layer"]}
    metrics: Dict[str, Dict] = {}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        import profiling as tr

        rec = out["trace"]
        rec.update(config=cell.config, family=cell.config["family"], cell=workload)
        for name, path in cell.readers.items():
            v = _module(path).read(rec)
            if v is not None:
                metrics[name] = {"value": v, "unit": units[name]}
        lo, hi = rec["window"]
        dev_info["busy_s"] = sum(b - a for a, b in tr.busy_intervals(rec["device"], rec["window"])) / 1e6
        dev_info["window_s"] = (hi - lo) / 1e6
        result.update(metrics=metrics, device=dev_info, breakdown=_breakdown(rec))
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup.get("s"), "unit": "s"}
            else:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}
        result.update(metrics=metrics, device=dev_info)
    if control:
        result["control"] = {name: {"correct": ok, "compared": cmp, "readings": sides[name]}
                             for name, (cmp, ok) in judged.items()}
    result["window"] = {"seconds": out["window_s"], **out["counts"]}
    print("set-up, seconds from the process's start: "
          + ", ".join(f"{n} {t:.2f}" for n, t in phases + [("window", setup.get("s", 0.0))]),
          file=sys.stderr)
    result["compared"] = compared
    for k, v in compared.items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    return result
