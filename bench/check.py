"""What decides ``correct`` for a serving cell: the served tokens against
the plain float32 reference.

Once the window has closed and the program is freed, a sample of the
window's finished requests is drawn from the seed, the longest among
them.  The reference runs once over each prompt with its served tokens
(teacher-forced, in float32 with TF32 off) and gives the logits at every
position that chose a served token.  The number compared is the widest
gap by which a served token lies below the reference's own choice under
the same draw (``reference.draw.gap``): the best logit less the served
one for greedy requests; for sampled ones the same Gumbel noise on the
reference's logits, within its top-k.

The control (``bench/control.py``) puts the reference, with every served
matrix rounded to float8, in the program's place: at each of those
positions the token float8 chooses stands where the served token stood,
and the same gap is read of it, so that the harness judges it by the same
limit as the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from reference import draw

__all__ = ["gaps", "pick"]


def pick(served: List[Dict], n: int, seed: int) -> List[Dict]:
    """The longest finished request (prompt and served tokens), and ``n -
    1`` others drawn from the seed."""
    done = [r for r in served if r.get("tokens")]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: done[i]["prompt_len"] + len(done[i]["tokens"]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.Generator(np.random.PCG64([int(seed), 0xC4EC]))
    more = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [done[longest]] + [done[rest[int(i)]] for i in sorted(more)]


def _sequence(c: Dict, r: Dict, pad_state: bool):
    """Token ids fed to the reference, and the rows whose logits chose
    each served token.  ``pad_state``: the served prompt's right padding
    (to the batch's longest) runs through the model before the decode, as
    a recurrent family's static batch does."""
    tok = c["tokenizer"]
    prompt = [tok["bos"]] + list(r["text"].encode("utf-8"))
    out = r["tokens"]
    n = len(prompt)
    if pad_state and r.get("pad_to", n) > n:
        pad = r["pad_to"] - n
        seq = prompt + [tok["pad"]] * pad + out[:-1]
        rows = [n - 1] + [n + pad + k - 1 for k in range(1, len(out))]
    else:
        seq = prompt + out[:-1]
        rows = [n - 1 + k for k in range(len(out))]
    return torch.tensor(seq, dtype=torch.long), torch.tensor(rows, dtype=torch.long)


def _readings(ref, tokens, seeds, index, t, k) -> Dict[str, float]:
    """The gaps of ``tokens``, one a position, below the reference's own
    choice (``draw.gap``): their widest, the number compared, and how they
    spread."""
    g = draw.gap(ref, tokens, seeds, index, t, k).cpu()
    return {"logit_gap_max": float(g.max()), "tokens": int(g.numel()),
            "gap_p50": float(g.quantile(0.5)), "gap_p90": float(g.quantile(0.9)),
            "gap_zero": float((g == 0).float().mean())}


def gaps(ctx, served: List[Dict], control: bool = False) -> Dict[str, Dict[str, float]]:
    """``{"program": readings}`` of the served tokens of the sampled
    requests, and with ``control`` ``"control": readings`` of the tokens
    the float8 reference chooses at the same positions."""
    mix, c = ctx.mix, ctx.config
    chosen = pick(served, mix["check"]["requests"], ctx.seed)
    if not chosen:
        return {"program": {"logit_gap_max": float("inf"), "tokens": 0}}
    pad_state = bool(getattr(ctx.ref, "PAD_STATE", False))
    seqs, rows = zip(*(_sequence(c, r, pad_state) for r in chosen))
    samp = mix.get("sampling")
    served_tok = torch.cat([torch.tensor(r["tokens"]) for r in chosen])
    if samp:
        seeds = torch.cat([torch.full((len(r["tokens"]),), r["seed"], dtype=torch.long)
                           for r in chosen])
        index = torch.cat([torch.arange(len(r["tokens"])) for r in chosen])
        t, k = samp["temperature"], samp["top_k"]
    else:
        seeds = index = None
        t, k = 1.0, 0
    dev = ctx.device
    ref = torch.cat(ctx.ref.logits(c, ctx.seed, seqs, rows, dev))
    out = {"program": _readings(ref, served_tok, seeds, index, t, k)}
    out["program"]["logit_std"] = float(ref.std(dim=-1).mean())
    if control:
        low = torch.cat(ctx.ref.logits(c, ctx.seed, seqs, rows, dev, fp8=True))
        if seeds is None:
            pick_low = low.argmax(-1)
        else:
            pick_low = draw.choice(low, seeds.to(dev), index.to(dev), t, k)
        out["control"] = _readings(ref, pick_low, seeds, index, t, k)
        out["control"]["agree"] = float((pick_low.cpu() == served_tok).float().mean())
    return out
