"""Closed-loop clients on the continuous engine (``ContinuousEngine.submit``,
paged KV cache, each decode step one CUDA graph on the card).

``clients`` clients each keep one request in flight: when a request
finishes its client submits the next, all from this one thread.  The
engine's loop runs in the thread of the first ``submit`` (its leader) and
delivers each finished request to its future's callback, which submits
the client's next request (``lead=False``) and returns; the loop admits it
at the next step boundary.  Set-up ends, and the window opens, once every
client has had a request finish (every slot filled and turned over once).
The window closes at the first decode step that starts ``seconds`` later;
no request is submitted after that, and those in flight are served to
their end.

Per request: time to first token, from the client's ``submit`` to the
moment its first token is on the host (the result's decode time counted
back from its delivery), whose tail is the 90th percentile: the highest
that keeps ten requests beyond it in a window of ~190; and its inter-token
gaps, on the card's clock, from its prefill's end to the end of its first
decode step and between the ends of its consecutive steps (an admission
prefill between two steps falls inside the gap).  Requests submitted in
the window count toward the tails.  The rate, the cell's end-to-end
metric, counts every token emitted in the window; the loop runs at its
capacity, where the tails swing with the host, so they are the traced
run's per-layer readings.
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
    from repro_torch.serve.engine import ServeConfig
    from repro_torch.serve.kvcache import PagedCacheSpec, blocks_for
    from repro_torch.serve.scheduler import ContinuousEngine

    ctx.phase("program")
    mix, c, dev = ctx.mix, ctx.config, ctx.device
    cfg, model = program.build(c, ctx.ref, ctx.seed, dev)
    ctx.phase("weights")
    bs, slots = mix["block_size"], mix["clients"]
    m = blocks_for(mix["max_len"], bs)
    spec = PagedCacheSpec(n_blocks=slots * m + (m if mix["prefix_cache"] else 0) + 2,
                          block_size=bs, max_slots=slots, max_blocks_per_seq=m)
    samp = mix["sampling"]
    engine = ContinuousEngine(
        cfg, model, spec,
        ServeConfig(max_new_tokens=mix["output"]["max"], max_len=spec.max_len,
                    greedy=samp is None,
                    temperature=samp["temperature"] if samp else 1.0,
                    top_k=samp["top_k"] if samp else 0),
        prefix_cache=mix["prefix_cache"], device=dev)
    ctx.phase("engine")
    prefills: List[Dict] = []
    tracer = Tracer(ctx.trace)
    program.wrap_prefill(engine, prefills, lambda: tracer.running)
    traffic = ctx.traffic

    reqs: List[Dict] = []          # in submission order
    state = {"turned": set(), "t_start": None, "deadline": None, "t_end": None,
             "tok_start": 0, "tok_end": None, "trace_until": None, "error": None}

    def submit(client: int) -> None:
        r = dict(traffic.request(len(reqs)))
        r.update(client=client, t_submit=ctx.now(), in_window=state["t_start"] is not None)
        reqs.append(r)
        r["future"] = engine.submit(r["text"], max_new_tokens=r["budget"],
                                    lead=False, seed=r["seed"])
        r["future"].add_done_callback(lambda f, r=r: done(r, f))

    def done(r: Dict, f) -> None:
        try:
            now = ctx.now()
            if f.exception() is not None:
                r["failed"] = True
                r.pop("future")
                return
            res = f.result()
            r.update(tokens=res.token_ids, steps=res.steps, step_end=engine.stats.steps,
                     t_first=now - res.decode_s)
            if state["t_start"] is None:
                state["turned"].add(r["client"])
                if len(state["turned"]) == mix["clients"]:
                    state["t_start"] = now
                    ctx.mark_setup()
                    state["deadline"] = now + ctx.seconds
                    state["tok_start"] = engine.stats.tokens_out
                    state["trace_until"] = now + ctx.trace_seconds
                    tracer.open()
            if state["deadline"] is None or now < state["deadline"]:
                submit(r["client"])
            r.pop("future")   # it holds this callback, and so the engine
        except Exception as e:  # the engine's loop would only log it: raised after
            state["error"] = e

    def tick():
        """Before every decode step: close the window or the trace; the
        step's number and whether it is traced."""
        now = ctx.now()
        if state["deadline"] is not None and state["t_end"] is None and now >= state["deadline"]:
            state["t_end"] = now
            state["tok_end"] = engine.stats.tokens_out
        if tracer.running and now >= state["trace_until"]:
            tracer.stop()
        return engine.stats.steps + 1, tracer.running

    marks = program.Marks(engine, "decode_step_paged", tick)
    with marks:
        for client in range(mix["clients"]):
            submit(client)
        engine.generate([])   # lead: the loop runs here until all are served
    if state["error"] is not None:
        raise state["error"]
    rec = tracer.close()
    if state["t_end"] is None:
        raise RuntimeError("the window never closed: the run served too few steps")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    out = _measure(ctx, reqs, prefills, marks.steps, state)
    out["memory_peak_bytes"] = peak
    if rec is not None:
        rec["prefills"] = [p for p in prefills if p["tag"]]
        rec["steps"] = _traced_steps(ctx, reqs, marks.steps)
        rec["tails"] = out["tails"]
        out["trace"] = rec
    engine.close()
    return out


def _ends(ctx, steps) -> Dict[int, float]:
    """Each step's end on the card's clock, ms after the run's origin."""
    return {tag[0]: ctx.origin.elapsed_time(end) for _, end, tag in steps}


def _measure(ctx, reqs, prefills, steps, state) -> Dict:
    import stats

    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    if len(prefills) != len(reqs):
        raise RuntimeError(f"{len(prefills)} prefills for {len(reqs)} requests")
    end = _ends(ctx, steps)
    ttft, itl, served, failed = [], [], [], 0
    for r, p in zip(reqs, prefills):
        if p["kind"] == "prefill" and p["lengths"][0] != r["prompt_len"]:
            raise RuntimeError("a prefill out of submission order")
        if not r["in_window"]:
            continue
        if r.get("failed"):
            failed += 1
            continue
        ttft.append((r["t_first"] - r["t_submit"]) * 1e3)
        first = r["step_end"] - r["steps"] + 1
        t = ctx.origin.elapsed_time(p["end"])
        for s in range(first, r["step_end"] + 1):
            itl.append(end[s] - t)
            t = end[s]
        served.append(r)
    window = state["t_end"] - state["t_start"]
    return {
        "attempted": sum(r["in_window"] for r in reqs), "failed": failed,
        "window_s": window, "served": served,
        "e2e": {"chat_tokens_per_s": (state["tok_end"] - state["tok_start"]) / window},
        "tails": {"ttft_p90_ms": stats.percentile(ttft, 90),
                  "itl_p95_ms": stats.percentile(itl, 95)},
        "counts": {"requests": len(ttft), "gaps": len(itl),
                   "ttft_ms": {f"p{q}": stats.percentile(ttft, q) for q in (50, 90, 95, 99)},
                   "itl_ms": {f"p{q}": stats.percentile(itl, q) for q in (50, 90, 95, 99)}},
    }


def _traced_steps(ctx, reqs, steps) -> List[Dict]:
    """The traced decode steps: device ms, and the context of each lane
    that held a request (the keys its new token attends to)."""
    ctxs: Dict[int, List[int]] = {}
    for r in reqs:
        if "step_end" not in r:
            continue
        first = r["step_end"] - r["steps"] + 1
        for k in range(r["steps"]):
            ctxs.setdefault(first + k, []).append(r["prompt_len"] + k + 1)
    return [{"ms": start.elapsed_time(end), "contexts": ctxs.get(tag[0], [])}
            for start, end, tag in steps if tag[1]]
