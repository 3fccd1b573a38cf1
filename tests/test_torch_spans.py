"""The port's host spans and request records, on the CPU under
``torch.profiler``: what ``runtime.trace.span`` records, read from the raw
kineto event list as the benchmark's tracer reads it.

* ``span()`` is one shared null context with no profiler running, and a
  ``record_function`` under one.
* ``ContinuousEngine`` (eager and static steps, prefix cache on, prompts
  sharing blocks): every span, each child inside its named parent, the
  prefix probe outside the admission's prefill span, one prefill span an
  admission and one decode span a step (the spans that existed before keep
  their count and extent); the results' ``queue_s`` in admission order.
* ``Engine.generate``: its spans, one ``Engine.decode.replay`` a step.
* ``Trainer.run`` over an ``IndexedDataset``: ``Trainer.batch`` and its three
  children, the step's spans once a step, and ``batch_s`` in each record.
"""

import contextlib
import dataclasses

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.registry import build_model
from repro_torch.runtime import trace
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.kvcache import PagedCacheSpec
from repro_torch.serve.scheduler import ContinuousEngine

STEM = "InChI=1S/C8H9NO2/c1-6(10)9-7-2-4-8(11)5-3-7;"
PROMPTS = [STEM + "a1", STEM + "b22", STEM + "a1c333"]
BS, MAX_LEN = 8, 96


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _spans(prof, prefixes=("Engine.", "ContinuousEngine.", "Trainer.", "IndexedDataset.")):
    """``{name: [(t0, t1, thread)]}`` of the host spans whose name starts
    with one of ``prefixes``, in ns of the profiler's clock, sorted."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.name().startswith(prefixes):
            t0 = e.start_ns()
            out.setdefault(e.name(), []).append((t0, t0 + e.duration_ns(), e.start_thread_id()))
    for v in out.values():
        v.sort()
    return out


def _inside(child, parents) -> bool:
    return any(a <= c0 and c1 <= b for c0, c1, _ in [child] for a, b, _ in parents)


def _overlaps(x, spans) -> bool:
    return any(x[0] < b and a < x[1] for a, b, _ in spans)


def _model():
    cfg = dataclasses.replace(
        get_config("yi-6b"), n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=300, dtype="float32")
    return cfg, build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")


def test_span_is_a_shared_null_context_without_a_profiler():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = trace.span("a"), trace.span("b")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = trace.span("on")
        assert isinstance(on, torch.autograd.profiler.record_function)
        with on:
            pass
    assert trace.span("c") is a
    assert len(_spans(prof, ("on",))["on"]) == 1


CONTINUOUS_CHILDREN = {
    "ContinuousEngine.prefill.model": "ContinuousEngine.prefill",
    "ContinuousEngine.prefill.first_token": "ContinuousEngine.prefill",
    "ContinuousEngine.prefill.cache_write": "ContinuousEngine.prefill",
    "ContinuousEngine.prefix_publish": "ContinuousEngine.prefill",
    "ContinuousEngine.decode.lanes_in": "ContinuousEngine.decode",
    "ContinuousEngine.decode.replay": "ContinuousEngine.decode",
    "ContinuousEngine.decode.readback": "ContinuousEngine.decode",
}


@pytest.mark.parametrize("decode", ["eager", "static"])
def test_continuous_engine_spans_and_request_records(decode):
    cfg, model = _model()
    spec = PagedCacheSpec(n_blocks=40, block_size=BS, max_slots=2,
                          max_blocks_per_seq=MAX_LEN // BS)
    eng = ContinuousEngine(cfg, model, spec, ServeConfig(max_new_tokens=6, max_len=MAX_LEN),
                           prefix_cache=True, device="cpu", decode=decode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        futs = [eng.submit(p, lead=False) for p in PROMPTS]
        futs.append(eng.submit(STEM + "zz", max_new_tokens=1, lead=False))
        eng.generate([])         # lead: serve every queued request here
        res = [f.result() for f in futs]
    eng.close()
    sp = _spans(prof)
    st = eng.stats
    assert st.prefix_hits >= 1 and st.prefills == len(futs) == st.completed

    names = set(CONTINUOUS_CHILDREN) | {"ContinuousEngine.prefix_match",
                                        "ContinuousEngine.prefill",
                                        "ContinuousEngine.decode",
                                        "ContinuousEngine.emit"}
    assert names <= set(sp), names - set(sp)
    assert len({t for v in sp.values() for *_, t in v}) == 1     # one thread
    for child, parent in CONTINUOUS_CHILDREN.items():
        for s in sp[child]:
            assert _inside(s, sp[parent]), child
    # the probe precedes the admission's prefill span, as before
    for s in sp["ContinuousEngine.prefix_match"]:
        assert not _overlaps(s, sp["ContinuousEngine.prefill"])
    # the emit loop runs after its decode span
    for s in sp["ContinuousEngine.emit"]:
        assert not _overlaps(s, sp["ContinuousEngine.decode"])
    # one prefill span an admission, one decode span (and one of each
    # child) a step: the spans that existed before keep their count
    assert len(sp["ContinuousEngine.prefill"]) == st.prefills
    for n in ("ContinuousEngine.decode", "ContinuousEngine.decode.lanes_in",
              "ContinuousEngine.decode.replay", "ContinuousEngine.decode.readback",
              "ContinuousEngine.emit"):
        assert len(sp[n]) == st.steps, n
    assert len(sp["ContinuousEngine.prefill.first_token"]) == st.prefills
    assert len(sp["ContinuousEngine.prefill.model"]) == st.prefills
    # each admission publishes its prompt's full blocks once (the
    # prefill-only request hit the index, so it held blocks and publishes)
    assert len(sp["ContinuousEngine.prefix_publish"]) == st.prefills

    assert all(r.queue_s >= 0.0 for r in res)
    assert res[-1].steps == 0
    assert all(1 <= r.steps <= st.steps for r in res[:-1])
    # requests admitted later waited longer (FIFO, one at a time)
    assert res[0].queue_s <= res[1].queue_s <= res[2].queue_s


@pytest.mark.parametrize("decode", ["eager", "static"])
def test_static_engine_spans(decode):
    cfg, model = _model()
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=7, max_len=MAX_LEN, sync_every=2),
                 device="cpu", decode=decode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = eng.generate(PROMPTS[:2])
    sp = _spans(prof)
    names = {"Engine.inputs", "Engine.prefill", "Engine.decode", "Engine.decode.replay",
             "Engine.decode.done_check", "Engine.readback"}
    if decode == "static":
        names.add("Engine.decode.start")
    assert names <= set(sp), names - set(sp)
    assert len(sp["Engine.decode.replay"]) == res[0].steps
    for n in names - {"Engine.decode.replay", "Engine.decode.done_check"}:
        assert len(sp[n]) == 1, n
    for n in ("Engine.decode.replay", "Engine.decode.done_check"):
        for s in sp[n]:
            assert _inside(s, sp["Engine.decode"]), n
    order = ["Engine.inputs", "Engine.prefill", "Engine.decode", "Engine.readback"]
    starts = [sp[n][0][0] for n in order]
    assert starts == sorted(starts)
    assert sp["Engine.inputs"][0][1] <= sp["Engine.prefill"][0][0]
    assert sp["Engine.decode"][0][1] <= sp["Engine.readback"][0][0]
    assert res[0].queue_s == 0.0


def test_trainer_spans_and_batch_seconds(tmp_path):
    from repro_torch.launch.train import build, build_parser

    args = build_parser().parse_args([
        "--arch", "mamba2-1.3b", "--device", "cpu", "--steps", "2", "--seq-len", "64",
        "--global-batch", "4", "--corpus-records", "40", "--workdir", str(tmp_path)])
    tr, ds = build(args)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            final, _, hist = tr.run()
    finally:
        ds.close()
    assert final == 2 and len(hist) == 2
    sp = _spans(prof)
    for n in ("Trainer.batch", "Trainer.step", "Trainer.readback", "Trainer.heartbeat",
              "IndexedDataset.fetch", "IndexedDataset.tokenize", "Trainer.upload"):
        assert len(sp.get(n, [])) == len(hist), n
    for n in ("IndexedDataset.fetch", "IndexedDataset.tokenize", "Trainer.upload"):
        for s in sp[n]:
            assert _inside(s, sp["Trainer.batch"]), n
    for a, b in zip(sp["Trainer.batch"], sp["Trainer.step"]):
        assert a[1] <= b[0]
    for a, b in zip(sp["Trainer.step"], sp["Trainer.readback"]):
        assert a[1] <= b[0]
    assert len(sp["Trainer.checkpoint"]) == 1      # the last step's save
    for rec in hist:
        assert rec["batch_s"] > 0.0 and rec["dt"] > 0.0
    assert "ckpt_s" in hist[-1]
