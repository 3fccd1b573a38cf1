"""Readers of the per-layer metrics that the chat and the docs cells both
have: each cell kind has its own name for them (``.chat``, ``.docs``),
since they move different end-to-end metrics, and its file under
``layer_metrics/`` binds one of these."""

import profiling
import work

_SPANS = ("Engine.prefill", "ContinuousEngine.prefill")


def _inside(rec, kernel=None):
    spans = sorted(s for n in _SPANS for s in rec["spans"].get(n, []))
    ops = profiling.inside(rec["device"], spans)
    return [op for op in ops if kernel is None or kernel in op[0]]


def us_per_token(rec):
    """Device time of the traced window's prefills over the prompt
    positions they processed, padding included, in us: the device
    operations that start inside the engines' prefill spans."""
    ops = _inside(rec)
    tokens = sum(p["b"] * p["s"] for p in rec.get("prefills") or [])
    if not ops or not tokens:
        return None
    return sum(b - a for _, a, b in ops) / tokens


def mfu(rec):
    """The prefills' share of the card's peak, in %: the least time their
    useful work could take (the larger of the model's FLOPs over the prompt
    tokens at 989 TFLOP/s and its weights' bytes at 3.35 TB/s, each prefill
    counted from its shapes by ``bench/work.py``) over the device time
    inside the prefill spans."""
    ops = _inside(rec)
    prefills = rec.get("prefills") or []
    if not ops or not prefills:
        return None
    fam = work.family(rec["family"])
    least = sum(work.bound_s(w["flops"], w["bytes"])
                for w in (fam.prefill(rec["config"], p["b"], p["s"], p["lengths"])
                          for p in prefills))
    return 100.0 * least / (sum(b - a for _, a, b in ops) / 1e6)


def flash_attention_roofline(rec):
    """``flash_attention``'s share of its roofline in the traced prefills,
    in %: its work at the shapes it is launched at (``attention_work``,
    frozen in ``bench/work.py``, one call a layer) over the device time of
    its kernels (``fa_forward*``) inside the prefill spans."""
    return kernel_roofline(rec, "fa_forward", "attn")


def kernel_roofline(rec, kernel: str, key: str):
    """A kernel's share of its roofline in the traced prefills, in %: the
    ``<key>_flops`` and ``<key>_bytes`` of the family's prefill work (the
    kernel's calls at their launch shapes) over the device time of the
    kernels named ``kernel`` inside the prefill spans; None where the
    family's prefill has no such work or no such kernel ran."""
    ops = _inside(rec, kernel)
    prefills = rec.get("prefills") or []
    if not ops or not prefills:
        return None
    fam = work.family(rec["family"])
    least = 0.0
    for p in prefills:
        w = fam.prefill(rec["config"], p["b"], p["s"], p["lengths"])
        if f"{key}_flops" not in w:
            return None
        least += work.bound_s(w[f"{key}_flops"], w[f"{key}_bytes"])
    return 100.0 * least / (sum(b - a for _, a, b in ops) / 1e6)


def decode_step_ms(rec):
    """Mean device time of a decode step in the traced window: CUDA events
    around each step (a graph replay on the card), in ms."""
    steps = rec.get("steps") or []
    if not steps:
        return None
    return sum(s["ms"] for s in steps) / len(steps)


def mfu_decode(rec):
    """The decode steps' share of the card's peak, in %: the least time
    each traced step's useful work could take (every weight read once,
    each lane that holds a request reading its cache or state; FLOPs of
    those lanes), from ``bench/work.py``, over the steps' device time."""
    steps = rec.get("steps") or []
    if not steps:
        return None
    c, fam = rec["config"], work.family(rec["family"])
    least = 0.0
    for s in steps:
        if s["contexts"]:
            w = fam.decode(c, s["contexts"])
            least += work.bound_s(w["flops"], w["bytes"])
    return 100.0 * least / (sum(s["ms"] for s in steps) / 1e3)


def idle_share(rec):
    """Share of the traced window in which no device operation runs (the
    profiler's timeline), in %."""
    lo, hi = rec["window"]
    if hi <= lo or not rec["device"]:
        return None
    busy = sum(b - a for a, b in profiling.busy_intervals(rec["device"], rec["window"]))
    return 100.0 * (1.0 - busy / (hi - lo))


def tail(name):
    """A reader of the window's tail ``name``, which the traffic loop took
    over every request or gap of the traced run's window."""
    def read(rec):
        return (rec.get("tails") or {}).get(name)
    return read
