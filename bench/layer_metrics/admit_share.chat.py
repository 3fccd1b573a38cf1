"""Share of the traced window the continuous engine spends admitting
requests: host time inside its ``ContinuousEngine.prefill`` spans (one
admission's prefill and first token each) over the window, in %."""


def read(rec):
    lo, hi = rec["window"]
    spans = rec["spans"].get("ContinuousEngine.prefill", [])
    t = sum(min(b, hi) - max(a, lo) for a, b in spans if b > lo and a < hi)
    if not spans or hi <= lo:
        return None
    return 100.0 * t / (hi - lo)
