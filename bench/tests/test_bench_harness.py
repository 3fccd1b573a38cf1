"""The harness end to end on the CPU at a tiny size: a run of each cell
is correct, a planted fault makes it incorrect, a stall inside the window
moves its rate and tails, a file added later is found by name, and the
run refuses to print a result without a card or with the JAX package
loaded."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import harness

CELLS = ("yi6b-chat", "mamba2-docs")
# the tiny training cell's limits: above the program's readings (gradients
# 2e-3, changes 6e-3), below the float8 control's (0.034, 0.026) and the
# half-batch fault's (0.053, 0.046); the losses are reported, not compared,
# as in the full cell
TRAIN_LIMITS = {"rows_wrong": 0, "grad_gap": 0.012, "change_gap": 0.014}
# the tiny cells' own limits: above their readings (0 to ~0.003 of a logit,
# against logits of std ~0.16), below the control's (mamba2-docs 0.017 to
# 0.064 over 48 checked tokens, yi6b-chat up to 0.75) and a wrong token's
# (a tenth of a logit and more)
TINY_LIMIT = {"yi6b-chat": 0.01, "mamba2-docs": 0.008}


def _limits(root):
    for w in CELLS:
        (root / "bench" / "cells" / f"{w}.json").write_text(
            json.dumps({"logit_gap_max": TINY_LIMIT[w]}))
    (root / "bench" / "cells" / "mamba2-train.json").write_text(json.dumps(TRAIN_LIMITS))


def _run(root, w, seed=7, seconds=1.0, trace=False, control=False):
    return harness.run_cell(w, seed, seconds, trace, time.perf_counter(), root,
                            device="cpu", bench=root / "bench", control=control)


@pytest.mark.parametrize("w", CELLS)
def test_a_run_is_correct_and_reports_every_metric(tiny_root, w):
    _limits(tiny_root)
    r = _run(tiny_root, w, seed=2 ** 31 + 99)
    assert r["correct"], r["compared"]
    names = {m["name"] for m in harness.load_cell(w, tiny_root, tiny_root / "bench").end_to_end}
    assert set(r["metrics"]) == names and "setup_s" in names
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "compared"


@pytest.mark.parametrize("w", CELLS)
def test_the_control_comes_out_not_correct(tiny_root, w):
    """The reference at float8 weights, put in the program's place, is
    judged by the harness's own comparison and comes out not correct,
    where the program's run is correct (``control.py``'s lines)."""
    import control

    _limits(tiny_root)
    lines = list(control.runs(w, [11, 2 ** 31 + 12], 1.0, tiny_root, device="cpu",
                              bench=tiny_root / "bench"))
    for line in lines:
        sides = line["sides"]
        assert set(sides) == {"program", "control"}
        assert sides["program"]["correct"], sides["program"]["compared"]
        assert not sides["control"]["correct"], sides["control"]["compared"]
        assert control.separated(line)


@pytest.mark.parametrize("w,cls", [("yi6b-chat", "scheduler.ContinuousEngine"),
                                   ("mamba2-docs", "engine.Engine")])
def test_a_token_altered_where_it_is_produced_is_caught(tiny_root, monkeypatch, w, cls):
    import importlib

    mod, name = cls.split(".")
    klass = getattr(importlib.import_module(f"repro_torch.serve.{mod}"), name)
    real = klass._next

    def altered(self, logits, *a, **k):
        tok = real(self, logits, *a, **k)
        return (tok + 1) % 259     # another byte than the one chosen
    monkeypatch.setattr(klass, "_next", altered)
    _limits(tiny_root)
    assert not _run(tiny_root, w)["correct"]


def test_training_is_correct_and_its_control_and_faults_are_not(tiny_root):
    """The training cell: correct; the float8 control, the half-batch fault
    and a state left unchanged, each put in the program's place, come out
    not correct by the harness's own comparison."""
    import control

    _limits(tiny_root)
    r = _run(tiny_root, "mamba2-train", seed=2 ** 31 + 5, seconds=1.5, control=True)
    assert r["correct"], r["compared"]
    assert set(r["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert set(r["control"]) == {"program", "control", "fault_half", "state_unchanged"}
    for name, side in r["control"].items():
        assert side["correct"] == (name == "program"), (name, side["compared"])
    assert control.separated({"sides": r["control"]})


def test_training_program_in_float32_matches_the_reference(tiny_root):
    """The program's own float32 steps against the float32 reference: the
    same losses, gradients and changes to round-off."""
    _limits(tiny_root)
    r = harness.run_cell("mamba2-train", 3, 1.0, False, time.perf_counter(), tiny_root,
                         device="cpu", bench=tiny_root / "bench", control=True,
                         overrides={"torch_dtype": "float32"})
    got = r["control"]["program"]["readings"]
    assert got["rows_wrong"] == 0 and got["loss_gap"] < 1e-5
    assert got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3, got


def test_half_the_batch_left_out_is_caught(tiny_root, monkeypatch):
    """A fault planted in the program: each batch's second half masked out
    of the loss, the mean taken over the rest."""
    from repro_torch.data.pipeline import IndexedDataset

    real = IndexedDataset.batch_for

    def half(self, *a, **k):
        b = real(self, *a, **k)
        b["loss_mask"][len(b["loss_mask"]) // 2:] = 0
        return b
    monkeypatch.setattr(IndexedDataset, "batch_for", half)
    _limits(tiny_root)
    assert not _run(tiny_root, "mamba2-train", seed=4, seconds=1.0)["correct"]


def test_a_step_that_leaves_the_state_unchanged_is_caught(tiny_root, monkeypatch):
    """A fault planted in the program: the optimizer's step computes its
    moments and puts every parameter back as it was."""
    import repro_torch.train.loop as loop

    real = loop.adamw_update

    def unchanged(cfg, grads, opt_state, params):
        keep = {n: p.detach().clone() for n, p in params.items()}
        out = real(cfg, grads, opt_state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(keep[n])
        return out
    monkeypatch.setattr(loop, "adamw_update", unchanged)
    _limits(tiny_root)
    r = _run(tiny_root, "mamba2-train", seed=6, seconds=1.0)
    assert not r["correct"] and r["compared"]["change_gap"]["value"] > 0.5


def test_a_stall_in_the_window_moves_rate_and_tails(tiny_root, monkeypatch):
    from repro_torch.serve.engine import Engine

    _limits(tiny_root)
    base = _run(tiny_root, "mamba2-docs", seconds=2.0)["metrics"]
    real = Engine._step
    calls = {"n": 0}

    def slow(self, *a, **k):
        calls["n"] += 1
        if calls["n"] % 2 == 0:
            time.sleep(0.3)
        return real(self, *a, **k)
    monkeypatch.setattr(Engine, "_step", slow)
    stalled = _run(tiny_root, "mamba2-docs", seconds=2.0)["metrics"]
    assert stalled["output_tokens_per_s"]["value"] < 0.7 * base["output_tokens_per_s"]["value"]
    assert stalled["itl_p95_ms"]["value"] > base["itl_p95_ms"]["value"] + 200


def test_files_added_later_are_found_by_name(tiny_root):
    """A new mix, cell and per-layer metric are new files and entries; no
    file the benchmark has is edited."""
    bench = tiny_root / "bench"
    mix = json.loads((bench / "mixes" / "docs.json").read_text())
    (bench / "mixes" / "short.json").write_text(json.dumps(dict(mix, prompt={
        "dist": "uniform", "min": 8, "max": 30})))
    (bench / "cells" / "mamba2-short.json").write_text(
        json.dumps({"logit_gap_max": TINY_LIMIT["mamba2-docs"]}))
    (bench / "layer_metrics" / "prefills_traced.py").write_text(
        "def read(rec):\n    return float(len(rec['prefills'])) or None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "mamba2-short", "config": "mamba2-1.3b",
                              "traffic": "short", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "prefills_traced", "unit": "count", "better": "higher",
                              "source": "program_span", "layer": "engines",
                              "moves": "ttft_p95_ms", "workloads": ["mamba2-short"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("mamba2-short", tiny_root, bench)
    assert cell.mix["prompt"]["max"] == 30 and "prefills_traced" in cell.readers
    r = _run(tiny_root, "mamba2-short", trace=True)
    assert r["correct"] and r["metrics"]["prefills_traced"]["value"] >= 1


def test_a_traced_run_reports_its_window(tiny_root):
    _limits(tiny_root)
    r = _run(tiny_root, "yi6b-chat", trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert {"admit_share.chat", "decode_step_ms.chat", "mfu.decode.chat", "ttft_p90_ms.chat",
            "itl_p95_ms.chat"} <= set(r["metrics"])


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core.fake", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.delitem(sys.modules, "repro.core.fake")
    assert "repro_torch" in {m.split(".")[0] for m in sys.modules}
    assert harness.forbidden_modules() == []


def test_no_card_no_result(tmp_path):
    """Without a card the command prints nothing on standard output and
    exits with another code than 0."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    repo = Path(__file__).resolve().parents[2]
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "yi6b-chat",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=repo, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
