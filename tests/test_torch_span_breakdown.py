"""``scripts/span_breakdown.py`` on the CPU: its split of idle time by the
innermost span, and a traced run of each benchmark cell at a tiny size (the
benchmark's own ``bench/tests/tiny.py`` copy, each run in a process of its
own) in which the program's spans leave little of the idle time outside
every span."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "span_breakdown.py"


def _script():
    spec = importlib.util.spec_from_file_location("span_breakdown", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("spans, gaps, want", [
    # a parent with two children; the gap crosses all three and the outside
    ({"p": [(0, 10)], "a": [(1, 3)], "b": [(5, 8)]}, [(0, 12)],
     {"p": 5, "a": 2, "b": 3, "outside": 2}),
    # gaps wholly inside one child, and before every span
    ({"p": [(10, 20)], "c": [(12, 18)]}, [(13, 14), (15, 16), (2, 4)],
     {"c": 2, "outside": 2}),
    # siblings that touch: the later one owns the instant they share
    ({"a": [(0, 5)], "b": [(5, 9)]}, [(4, 6)], {"a": 1, "b": 1}),
    # no spans at all
    ({}, [(0, 3)], {"outside": 3}),
])
def test_idle_is_split_by_the_innermost_span(spans, gaps, want):
    assert _script().idle_by_span(gaps, spans) == pytest.approx(want)


CELLS = {
    "yi6b-chat": "ContinuousEngine.prefill.model",
    "mamba2-docs": "Engine.decode.replay",
    "mamba2-train": "Trainer.step",
}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    sys.path.insert(0, str(REPO / "bench" / "tests"))
    try:
        import tiny
    finally:
        sys.path.pop(0)
    return tiny.make(tmp_path_factory.mktemp("bench") / "root")


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_each_cell_gives_its_readings_from_the_new_spans(tiny_root, workload):
    p = subprocess.run(
        [sys.executable, str(SCRIPT), "--workload", workload, "--seed", "3000000017",
         "--seconds", "1", "--root", str(tiny_root), "--device", "cpu"],
        capture_output=True, text=True, timeout=240, cwd=str(REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["result"]["correct"]
    # the harness's own per-layer metrics are read as before
    assert out["result"]["metrics"]
    by = out["idle"]["by_span"]
    assert out["idle"]["total_ms"] > 0
    assert by[CELLS[workload]]["ms"] > 0, by
    assert by.get("outside", {"share": 0.0})["share"] < 0.25, by
