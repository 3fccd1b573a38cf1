"""Median host time of a training step in the traced window: the
``Trainer`` records' ``dt`` (the step, to its loss read back), in ms."""

import statistics


def read(rec):
    steps = rec.get("train_steps") or []
    if not steps:
        return None
    return 1e3 * statistics.median(s["dt"] for s in steps)
