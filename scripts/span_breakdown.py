"""Run one benchmark cell traced and split its device-idle time by the
innermost of the program's host spans: which host phase holds the card
idle.

    python3 scripts/span_breakdown.py --workload yi6b-chat --seed N \\
        [--seconds 51] [--root DIR] [--device cpu]

One traced run of ``bench/run.py``'s cell (``harness.run_cell``, in this
process) from the checkout ``--root`` (default: this one; a parent unpacked
under a git-ignored directory runs its own ``src`` and ``bench``).  Before
the run the benchmark tracer's list of kept spans (``profiling.SPANS``) is
extended here by the program's phase spans (:data:`PHASES`); the
benchmark's own files are read, not changed.  Prints one JSON line: the
harness's result, and ``idle``, the window's device-idle time
(``profiling.idle_gaps``) split by the innermost span open over each part
of it, in ms and as a share, ``outside`` where no span is open.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the program's host phases (spans on the launching thread); the
# benchmark's tracer keeps its own list
PHASES = (
    "ContinuousEngine.prefix_match", "ContinuousEngine.prefill.model",
    "ContinuousEngine.prefill.first_token", "ContinuousEngine.prefill.cache_write",
    "ContinuousEngine.prefix_publish", "ContinuousEngine.decode.lanes_in",
    "ContinuousEngine.decode.replay", "ContinuousEngine.decode.readback",
    "ContinuousEngine.emit",
    "Engine.inputs", "Engine.decode.start", "Engine.decode.replay",
    "Engine.decode.done_check", "Engine.readback",
    "Trainer.batch", "IndexedDataset.fetch", "IndexedDataset.tokenize", "Trainer.upload",
    "Trainer.step", "Trainer.readback", "Trainer.heartbeat", "Trainer.checkpoint",
)
OUTSIDE = "outside"


def idle_by_span(gaps, spans):
    """``{name: us}``: the idle intervals ``gaps`` split by the innermost
    span open over each of their parts; ``spans`` is ``{name: [(t0, t1)]}``
    of spans that nest."""
    ev = sorted([(a, 1, n) for n, v in spans.items() for a, _ in v]
                + [(b, 0, n) for n, v in spans.items() for _, b in v])
    stack, times, names = [], [], []       # from times[i] on, names[i] is innermost
    for t, opening, n in ev:
        if opening:
            stack.append(n)
        elif n in stack:
            del stack[len(stack) - 1 - stack[::-1].index(n)]
        top = stack[-1] if stack else OUTSIDE
        if times and times[-1] == t:
            names[-1] = top
        else:
            times.append(t)
            names.append(top)
    out = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(times, g0) - 1
        t = g0
        while t < g1:
            end = min(times[i + 1] if i + 1 < len(times) else g1, g1)
            top = names[i] if i >= 0 else OUTSIDE
            out[top] = out.get(top, 0.0) + (end - t)
            t, i = end, i + 1
    return out


def traced_run(workload, seed, seconds, root, device=None):
    """``(result, rec)``: the harness's result of one traced run, and the
    tracer's record of it with the phase spans kept."""
    bench = Path(root) / "bench"
    sys.path.insert(0, str(bench))
    import harness
    import profiling

    harness.environment(Path(root))
    profiling.SPANS = tuple(profiling.SPANS) + tuple(n for n in PHASES if n not in profiling.SPANS)
    recs = []
    close = profiling.Tracer.close

    def keep(self):
        rec = close(self)
        if rec is not None:
            recs.append(rec)
        return rec

    profiling.Tracer.close = keep
    result = harness.run_cell(workload, seed, seconds, True, t_process=T_PROCESS,
                              root=Path(root), device=device)
    return result, (recs[0] if recs else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--device", default=None,
                    help="run on this device (default: the cell's cards; 'cpu' for a tiny root)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    result, rec = traced_run(args.workload, args.seed, args.seconds, root, args.device)
    out = {"workload": args.workload, "seed": args.seed, "root": str(root), "result": result}
    if rec is not None:
        import profiling

        spans = {n: v for n, v in rec["spans"].items() if n != "bench.window"}
        idle = idle_by_span(profiling.idle_gaps(rec), spans)
        total = sum(idle.values())
        out["idle"] = {"total_ms": total / 1e3, "by_span": {
            n: {"ms": v / 1e3, "share": v / total if total else 0.0}
            for n, v in sorted(idle.items(), key=lambda kv: -kv[1])}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
