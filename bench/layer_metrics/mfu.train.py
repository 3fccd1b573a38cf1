"""The training steps' share of the card's bf16 peak, in %: 6 N (B S)
FLOPs a step (N the configuration's parameters, from ``bench/work.py``)
over the steps' ``dt`` at 989 TFLOP/s."""

import work


def read(rec):
    steps = rec.get("train_steps") or []
    if not steps:
        return None
    n = work.family(rec["family"]).params(rec["config"])["total"]
    flops = 6 * n * rec["tokens_per_step"] * len(steps)
    return 100.0 * flops / (sum(s["dt"] for s in steps) * work.PEAK_FLOPS)
