"""Batches back to back on the static engine (``Engine.generate``): an
offline job that sends its next batch when the last one returns.

Each batch is the mix's ``batch`` requests, right-padded by the engine to
the batch's longest prompt, prefilled once and decoded for ``new_tokens``
steps (one CUDA graph replay a step on the card).  Set-up serves one
batch of the cell's shapes (the graph capture with it); the window then
sends batches until ``seconds`` have passed and closes when the last one
returns.

Per request: time to first token, from the ``generate`` call to the end of
the synchronised prefill; its inter-token gaps on the card's clock, from
the prefill's end to the end of the first decode step that produced a
token it kept, and between the ends of consecutive such steps.  The rate
is every kept token of the window's batches over the window's seconds.
"""

from __future__ import annotations

from typing import Dict, List

import torch

import program
from check import gaps
from profiling import Tracer

__all__ = ["check", "run"]


def check(ctx, out: Dict, control: bool = False) -> Dict[str, Dict]:
    """The served tokens against the reference (``check.gaps``)."""
    return gaps(ctx, out["served"], control)


def run(ctx) -> Dict:
    import stats
    from repro_torch.serve.engine import Engine, ServeConfig

    ctx.phase("program")
    mix, c, dev = ctx.mix, ctx.config, ctx.device
    cfg, model = program.build(c, ctx.ref, ctx.seed, dev)
    ctx.phase("weights")
    engine = Engine(cfg, model,
                    ServeConfig(max_new_tokens=mix["new_tokens"], max_len=mix["max_len"],
                                greedy=True),
                    device=dev)
    tracer = Tracer(ctx.trace)
    prefills: List[Dict] = []
    program.wrap_prefill(engine, prefills, lambda: tracer.running)
    marks = program.Marks(engine, "decode_step", lambda: (0, tracer.running))
    traffic = ctx.traffic

    def serve(b: int) -> Dict:
        reqs = traffic.batch(b)
        n0 = len(marks.steps)
        t0 = ctx.now()
        res = engine.generate([r["text"] for r in reqs])
        t1 = ctx.now()
        p = prefills[-1]
        if p["lengths"] != [r["prompt_len"] for r in reqs]:
            raise RuntimeError("the prefill did not serve this batch's prompts")
        return {"reqs": reqs, "tokens": [x.token_ids for x in res], "t0": t0,
                "t1": t1, "prefill": p, "steps": marks.steps[n0:]}

    ctx.phase("engine")
    with marks:
        serve(0)                      # set-up: this cell's shapes, the capture
        ctx.mark_setup()
        t_start = ctx.now()
        deadline = t_start + ctx.seconds
        tracer.open()
        batches = []
        b = 1
        while not batches or ctx.now() < deadline:
            batches.append(serve(b))
            b += 1
            if tracer.running and ctx.now() - t_start >= ctx.trace_seconds:
                tracer.stop()
        t_end = ctx.now()
    rec = tracer.close()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.synchronize()

    ttft, itl, served, n_tok = [], [], [], 0
    traced_steps, traced_prefills = [], []
    for bt in batches:
        t_pre = ctx.origin.elapsed_time(bt["prefill"]["end"])
        ends = [ctx.origin.elapsed_time(end) for _, end, _ in bt["steps"]]
        for r, toks in zip(bt["reqs"], bt["tokens"]):
            ttft.append((bt["prefill"]["t_end"] - bt["t0"]) * 1e3)
            n_tok += len(toks)
            t = t_pre
            for j in range(len(toks) - 1):   # token j + 1 is step j's
                itl.append(ends[j] - t)
                t = ends[j]
            served.append(dict(r, tokens=toks, pad_to=bt["prefill"]["s"]))
        if bt["prefill"]["tag"]:
            traced_prefills.append(bt["prefill"])
        for j, (start, end, tag) in enumerate(bt["steps"]):
            if tag[1]:
                lens = [r["prompt_len"] + j + 1 for r, toks in zip(bt["reqs"], bt["tokens"])
                        if j < len(toks) - 1]
                traced_steps.append({"ms": start.elapsed_time(end), "contexts": lens})
    window = t_end - t_start
    out = {
        "attempted": len(served), "failed": 0, "window_s": window, "served": served,
        "memory_peak_bytes": peak,
        "e2e": {"output_tokens_per_s": n_tok / window,
                "ttft_p95_ms": stats.percentile(ttft, 95),
                "itl_p95_ms": stats.percentile(itl, 95)},
        "counts": {"requests": len(ttft), "gaps": len(itl), "batches": len(batches),
                   "ttft_ms": {f"p{q}": stats.percentile(ttft, q) for q in (50, 95)},
                   "itl_ms": {f"p{q}": stats.percentile(itl, q) for q in (50, 95)}},
    }
    if rec is not None:
        rec["prefills"], rec["steps"] = traced_prefills, traced_steps
        out["trace"] = rec
    return out
