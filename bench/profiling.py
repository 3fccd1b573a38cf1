"""The traced run's profiler: a window opened and closed by the cell's
traffic loop (``bench/drivers``; possibly from inside the program's own
loop), and what the per-layer readers read from it.

``Tracer.close()`` gives ``{"window": (t0, t1), "device": [(name, t0,
t1)], "spans": {name: [(t0, t1)]}}`` in microseconds of the profiler's
clock: every device operation (kernels, copies, sets), and the host spans
the program and the benchmark name.  The raw event list is read directly:
building the profiler's Python call tree costs tens of microseconds an
event, minutes for a traced decode.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

__all__ = ["SPANS", "Tracer", "busy_intervals", "idle_gaps"]

# host spans kept: the program's, and the benchmark's own around a window
SPANS = ("Engine.prefill", "Engine.decode", "ContinuousEngine.prefill",
         "ContinuousEngine.decode", "bench.window")


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._window = None

    def open(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._window = torch.autograd.profiler.record_function("bench.window")
        self._window.__enter__()

    @property
    def running(self) -> bool:
        return self.prof is not None and self._window is not None

    def stop(self) -> None:
        if not self.running:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._window = None
        self.prof.stop()

    def close(self) -> Optional[Dict]:
        if self.prof is None:
            return None
        self.stop()
        from torch.autograd import DeviceType

        device: List[Tuple[str, float, float]] = []
        spans: Dict[str, List[Tuple[float, float]]] = {n: [] for n in SPANS}
        for e in self.prof.profiler.kineto_results.events():
            t0 = e.start_ns() / 1e3
            t1 = t0 + e.duration_ns() / 1e3
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((e.name(), t0, t1))
            elif e.name() in spans:
                spans[e.name()].append((t0, t1))
        device.sort(key=lambda x: x[1])
        for v in spans.values():
            v.sort()
        win = spans["bench.window"]
        window = (win[0][0], win[-1][1]) if win else (
            (device[0][1], device[-1][2]) if device else (0.0, 0.0))
        self.prof = None
        return {"window": window, "device": device, "spans": spans}


def busy_intervals(device, window) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the
    window."""
    out: List[Tuple[float, float]] = []
    lo, hi = window
    for _, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def idle_gaps(rec) -> List[Tuple[float, float]]:
    """The window's intervals in which no device operation runs."""
    lo, hi = rec["window"]
    gaps, t = [], lo
    for a, b in busy_intervals(rec["device"], rec["window"]):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def inside(device, spans) -> List[Tuple[str, float, float]]:
    """The device operations that start inside one of ``spans`` (host
    intervals, sorted): on one stream, the work those calls launched."""
    import bisect

    starts = [a for a, _ in spans]
    out = []
    for op in device:
        i = bisect.bisect_right(starts, op[1]) - 1
        if i >= 0 and op[1] < spans[i][1]:
            out.append(op)
    return out
