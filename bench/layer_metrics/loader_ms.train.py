"""Mean host time a training step spends outside its ``dt`` in the traced
window: fetching its records by offset, verifying and tokenizing them and
uploading the batch (the time between the benchmark's ``on_step`` calls
less the step's own ``dt``), in ms."""


def read(rec):
    steps = rec.get("train_steps") or []
    if not steps:
        return None
    return 1e3 * sum(s["interval"] - s["dt"] for s in steps) / len(steps)
