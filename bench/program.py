"""What the benchmark takes from the program (the ``repro_torch`` package
under ``src/``): its configuration, its model filled with the benchmark's
own weights, and marks around the calls into its layers.

Nothing here changes what the program computes.  The wrappers time a call
and hand its result back unchanged: the prefill wrapper waits for the
device (the engines wait right after it anyway) and marks its end; the
step clock records CUDA events around each decode step, a graph replay on
the card or the model's step function where the engine runs eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import torch

__all__ = ["Marks", "build", "fill", "mark", "port_config", "wrap_prefill"]


def port_config(c: Dict, ref):
    """The port's ``ModelConfig`` of configuration file ``c``: the port's
    config named by ``c["arch"]``, with every field the file sets (mapped
    by the family reference's ``PORT_FIELDS``) as the file sets it, and
    those the family derives by a published rule (``port_values``)."""
    from repro_torch.configs import get_config

    values = {field: c[key] for key, field in ref.PORT_FIELDS.items() if key in c}
    if hasattr(ref, "port_values"):
        values.update(ref.port_values(c))
    return dataclasses.replace(get_config(c["arch"]), **values)


@torch.no_grad()
def fill(model, c: Dict, ref, seed: int, device) -> None:
    """Fill every parameter of ``model`` with the benchmark's draws of
    configuration file ``c`` (``ref.embed_spec``, ``ref.layer_spec``),
    group by group; each must be drawn, at its shape."""
    from reference.common import draw_group

    params = dict(model.named_parameters())
    seen = set()
    groups = [(-1, ref.embed_spec(c))] + [(i, ref.layer_spec(c, i))
                                         for i in range(ref.n_groups(c))]
    for g, spec in groups:
        for name, t in draw_group(spec, seed, g, device).items():
            p = params[name]
            if p.shape != t.shape:
                raise ValueError(f"{name}: the program holds {tuple(p.shape)}, "
                                 f"the benchmark draws {tuple(t.shape)}")
            p.copy_(t)
            seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise ValueError(f"parameters the benchmark does not draw: {missing[:8]}")


def build(c: Dict, ref, seed: int, device):
    """``(cfg, model)``: the port's model of configuration file ``c``, its
    parameters allocated on ``device`` (no draw of the program's own) and
    filled with the benchmark's (:func:`fill`)."""
    from repro_torch.device import construct_on_meta
    from repro_torch.models.registry import build_model

    cfg = port_config(c, ref)
    with construct_on_meta():
        model = build_model(cfg).init(torch.Generator(), "cpu")
    model = model.to_empty(device=device)
    fill(model, c, ref, seed, device)
    return cfg, model


class _HostMark:
    """A host-clock stand-in for a CUDA event (CPU runs)."""

    def __init__(self):
        self.t = 0.0

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostMark") -> float:
        return (end.t - self.t) * 1e3


def mark(device) -> object:
    """A recorded mark: a CUDA event on the card, the host clock elsewhere."""
    ev = (torch.cuda.Event(enable_timing=True) if torch.device(device).type == "cuda"
          else _HostMark())
    ev.record()
    return ev


class Marks:
    """Marks around every decode step while active: ``steps`` is a list of
    ``(start, end, tag)``, ``tag`` what ``tag_fn()`` returned before the
    step.  On an engine whose steps are CUDA graph replays the replay is
    wrapped; otherwise the model API's step function ``fn_name``."""

    def __init__(self, engine, fn_name: str, tag_fn):
        self.engine, self.fn_name, self.tag_fn = engine, fn_name, tag_fn
        self.steps: List[tuple] = []
        self.device = engine.device
        self.graph = engine.decode == "graph"
        self._saved = None

    def _timed(self, fn):
        steps, dev, tag_fn = self.steps, self.device, self.tag_fn

        def call(*a, **k):
            tag = tag_fn()
            start = mark(dev)
            out = fn(*a, **k)
            steps.append((start, mark(dev), tag))
            return out
        return call

    def __enter__(self):
        if self.graph:
            self._saved = torch.cuda.CUDAGraph.replay
            torch.cuda.CUDAGraph.replay = self._timed(self._saved)
        else:
            api = self.engine.api
            self._saved = api
            self.engine.api = dataclasses.replace(
                api, **{self.fn_name: self._timed(getattr(api, self.fn_name))})
        return self

    def __exit__(self, *exc):
        if self.graph:
            torch.cuda.CUDAGraph.replay = self._saved
        else:
            self.engine.api = self._saved


def wrap_prefill(engine, calls: List[Dict], tag_fn) -> None:
    """Wrap the engine's model API's ``prefill`` (and ``prefill_suffix``,
    where it has one): each call appends ``{"kind", "b", "s", "lengths",
    "t_end", "end", "tag"}`` to ``calls``: its padded shape and prompt
    lengths, the host time and a device mark after the call and the wait
    for the device, and what ``tag_fn()`` returned."""
    api = engine.api
    dev = engine.device

    def timed(fn, kind):
        def call(*a, **k):
            out = fn(*a, **k)
            if kind == "prefill":
                batch = a[1]
                tokens, lengths = batch["tokens"], batch["lengths"]
            else:
                tokens, lengths = a[1], k.get("lengths")
            end = mark(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            calls.append({"kind": kind, "b": int(tokens.shape[0]),
                          "s": int(tokens.shape[1]),
                          "lengths": [int(x) for x in lengths.tolist()],
                          "t_end": time.perf_counter(), "end": end,
                          "tag": tag_fn()})
            return out
        return call

    changes = {"prefill": timed(api.prefill, "prefill")}
    if api.prefill_suffix is not None:
        changes["prefill_suffix"] = timed(api.prefill_suffix, "suffix")
    engine.api = dataclasses.replace(api, **changes)
