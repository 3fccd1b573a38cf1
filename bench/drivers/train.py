"""Training steps of ``Trainer.run`` fed by the byte-offset index.

Set-up writes the seed's SDF corpus under ``TMPDIR`` (``corpus.sdfgen``),
lets the program build its byte-offset index over it and an
``IndexedDataset`` that fetches each step's records by offset and verifies
their ids with ``hash_mix`` on the card, builds the ``Trainer`` and its
state (float32 masters filled with the benchmark's draws, AdamW), and
drives that state through its first ``checked_steps`` steps with the
window's own call, one ``run`` a step.  It keeps what the comparison
needs: those steps' batches and losses, each parameter's gradient norm at
the first step as the optimizer took it (AdamW's first moment after one
step is ``(1 - b1)`` times the clipped gradient), and each parameter's
change over the checked steps.  The window then runs step after step on
the same state until ``seconds`` have passed.  No checkpoint is written:
each ``run`` ends at its step as ``die_at_step`` lets it.

The rate is the tokens under the loss mask (the positions the loss
predicts) of the window's steps over the window's seconds.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

import program
from profiling import Tracer

__all__ = ["check", "run"]


def run(ctx) -> Dict:
    from repro_torch.core import RecordStore, build_index
    from repro_torch.data.pipeline import IndexedDataset
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    from corpus import sdfgen

    ctx.phase("program")
    mix, c, dev = ctx.mix, ctx.config, ctx.device
    work = Path(tempfile.gettempdir()) / f"bench-train-{os.getpid()}"
    shutil.rmtree(work, ignore_errors=True)
    try:
        sdfgen.write(work / "corpus", ctx.seed, mix["files"], mix["records"] // mix["files"])
        ctx.phase("corpus")
        store = RecordStore(work / "corpus")
        ds = IndexedDataset(store, build_index(store, workers=1), mix["seq_len"], device=dev)
        ctx.phase("index")
        out = _train(ctx, ds, program.port_config(c, ctx.ref), work, AdamWConfig(**mix["opt"]),
                     Trainer, TrainerConfig)
        ds.close()
        out["rows_wrong"] = _judge_batches(work / "corpus", c, mix, out["first"]["batches"])
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _train(ctx, ds, cfg, work: Path, opt, Trainer, TrainerConfig) -> Dict:
    mix, c, dev = ctx.mix, ctx.config, ctx.device
    tr = Trainer(cfg, TrainerConfig(seq_len=mix["seq_len"], global_batch=mix["batch"],
                                    steps=1 << 40, ckpt_every=1 << 40, seed=ctx.seed,
                                    opt=opt),
                 ds, work / "run", device=dev)
    fetched: Dict[int, tuple] = {}
    real = ds.batch_for

    def batch_for(sampler, step, rank, n):
        b = real(sampler, step, rank, n)
        fetched[step] = (b if step < mix["checked_steps"] else None,
                         int(b["loss_mask"][:, 1:].sum()))
        return b
    ds.batch_for = batch_for

    state = tr.init_state()
    masters = dict(c, torch_dtype="float32")
    program.fill(state["model"], masters, ctx.ref, ctx.seed, dev)
    ctx.phase("state")
    first: Dict = {"loss": []}

    def one(on_step=None):
        nonlocal state
        s = int(state["step"])
        _, state, hist = tr.run(until_step=s + 1, state=state, die_at_step=s + 1,
                                on_step=on_step)
        return hist[0]

    for s in range(mix["checked_steps"]):
        first["loss"].append(one()["loss"])
        if s == 0:
            b1 = opt.b1
            first["grad_norm"] = {n: float(torch.linalg.vector_norm(m.float())) / (1 - b1)
                                  for n, m in state["opt"]["m"].items()}
    ctx.phase("checked steps")
    first["change"] = _change(state["model"], masters, ctx.ref, ctx.seed, dev)
    first["batches"] = [fetched[s][0] for s in range(mix["checked_steps"])]

    tracer = Tracer(ctx.trace)
    ctx.mark_setup()
    t_start = ctx.now()
    deadline = t_start + ctx.seconds
    steps: List[Dict] = []
    last = [t_start]

    def on_step(step, rec):
        now = ctx.now()
        steps.append({"step": step, "dt": rec["dt"], "interval": now - last[0],
                      "loss": rec["loss"], "traced": tracer.running})
        last[0] = now
        if tracer.running and now - t_start >= ctx.trace_seconds:
            tracer.stop()

    tracer.open()
    while ctx.now() < deadline:
        one(on_step)
    t_end = ctx.now()
    rec = tracer.close()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    window = t_end - t_start
    tokens = sum(fetched[s["step"]][1] for s in steps)
    out = {"attempted": len(steps),
           "failed": sum(not np.isfinite(s["loss"]) for s in steps),
           "window_s": window, "memory_peak_bytes": peak, "first": first,
           "e2e": {"train_tokens_per_s": tokens / window},
           "counts": {"steps": len(steps), "tokens": tokens}}
    if rec is not None:
        rec["train_steps"] = [s for s in steps if s["traced"]]
        rec["tokens_per_step"] = mix["batch"] * mix["seq_len"]
        out["trace"] = rec
    del state, tr
    return out


@torch.no_grad()
def _change(model, c: Dict, ref, seed: int, dev) -> Dict[str, float]:
    """Each parameter's distance from the benchmark's draw of it."""
    from reference.common import draw_group

    params = dict(model.named_parameters())
    out = {}
    groups = [(-1, ref.embed_spec(c))] + [(i, ref.layer_spec(c, i)) for i in range(ref.n_groups(c))]
    for g, spec in groups:
        for name, t in draw_group(spec, seed, g, dev).items():
            out[name] = float(torch.linalg.vector_norm(params[name].detach().float() - t))
    return out


def _judge_batches(corpus: Path, c: Dict, mix: Dict, batches) -> int:
    """Rows of the checked steps' batches that are not a record of the
    corpus rendered as the training text (``<id>`` newline ``XLOGP3=<v>``,
    or the id alone where the record has no XLOGP3; BOS, bytes, EOS, padded
    to the sequence length, the mask over the text), found by the raw SDF
    files' own parse; a record twice among them counts too."""
    from corpus.sdfgen import PROP_ID, PROP_XLOGP

    text = {}
    for path in sorted(Path(corpus).glob("*.sdf")):
        for rec in path.read_text(encoding="utf-8").split("$$$$\n"):
            lines = rec.split("\n")
            props = {lines[i][3:-1]: lines[i + 1] for i in range(len(lines) - 1)
                     if lines[i].startswith("> <")}
            if PROP_ID in props:
                rid = props[PROP_ID]
                text[rid] = f"{rid}\nXLOGP3={props[PROP_XLOGP]}" if PROP_XLOGP in props else rid
    tok, n = c["tokenizer"], mix["seq_len"]
    wrong, seen = 0, set()
    for b in batches:
        for row, mask in zip(b["tokens"], b["loss_mask"]):
            body = bytes(int(t) for t in row[1:] if t < 256).decode("utf-8", "replace")
            rid = body.split("\n")[0]
            ids = ([tok["bos"]] + list(text.get(rid, "").encode("utf-8")) + [tok["eos"]])[:n]
            want = np.full((n,), tok["pad"], np.int64)
            want[: len(ids)] = ids
            want_mask = (np.arange(n) < len(ids)).astype(np.float32)
            if (rid not in text or rid in seen or not np.array_equal(row.astype(np.int64), want)
                    or not np.array_equal(mask.astype(np.float32), want_mask)):
                wrong += 1
            seen.add(rid)
    return wrong


def _readings(first: Dict, ref: Dict) -> Dict[str, float]:
    """The program's (or a stand-in's) first steps against the reference's:
    the first step's loss gap over the reference's loss (and the worst
    step's, ``loss_gap``, reported beside it); the worst parameter's
    gradient-norm gap and change-norm gap, each over the reference's norm
    of that parameter or of the median parameter, whichever is larger.
    Parameters whose reference gradient is under a thousandth of the
    median's (round-off alone moves them under AdamW) are left out of the
    change."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(first["loss"], ref["loss"])]
    g_med = statistics.median(ref["grad_norm"].values())
    grad = max(abs(first["grad_norm"][n] - g) / max(g, g_med) for n, g in ref["grad_norm"].items())
    kept = [n for n, g in ref["grad_norm"].items() if g >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in kept)
    change = max(abs(first["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
                 for n in kept)
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "grad_gap": grad,
            "change_gap": change, "losses": list(first["loss"])}


def check(ctx, out: Dict, control: bool = False) -> Dict[str, Dict]:
    """``{"program": readings}``: the batches, losses, gradients and
    changes of the checked steps against the plain float32 reference's
    (``reference.<family>.train`` over the same batches, which the
    reference has judged first).  With ``control``, the same readings of
    each stand-in put in the program's place: the reference at float8
    (``"control"``), the fault that leaves each batch's second half out
    (``"fault_half"``) and the state left unchanged by the steps
    (``"state_unchanged"``); each takes the program's batches, and so its
    ``rows_wrong``."""
    mix, c, dev = ctx.mix, ctx.config, ctx.device
    first = out["first"]
    batches = [(torch.from_numpy(b["tokens"]).long(), torch.from_numpy(b["loss_mask"]).float())
               for b in first["batches"]]
    ref = ctx.ref.train(c, ctx.seed, batches, mix["opt"], dev, steps=mix["checked_steps"])
    rows = {"rows_wrong": float(out["rows_wrong"])}
    sides = {"program": dict(_readings(first, ref), reference_losses=list(ref["loss"]), **rows)}
    if control:
        for name, kw in (("control", {"fp8": True}), ("fault_half", {"half": True})):
            other = ctx.ref.train(c, ctx.seed, batches, mix["opt"], dev,
                                  steps=mix["checked_steps"], **kw)
            sides[name] = dict(_readings(other, ref), **rows)
        sides["state_unchanged"] = dict(_readings(
            {"loss": first["loss"], "grad_norm": first["grad_norm"],
             "change": {n: 0.0 for n in ref["change"]}}, ref), **rows)
    return sides
