"""The train state and the train step, the port of ``repro.train.loop``.

``make_train_state`` builds the model with float32 master parameters that
take gradients (each use casts them to the compute dtype, as the
reference's ``.astype(cdt)`` does) and AdamW state beside them::

    {"model": nn.Module, "opt": {"m": {name: t}, "v": {name: t},
     "count": int32}, "step": int32}

``make_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``: the loss and its gradients through autograd (every kernel on
the path carries a ``torch.autograd.Function``), optionally over
``grad_accum`` microbatches along axis 0 with a float32 accumulator (the
loss averaged, the metrics of the last microbatch), then the optional
gradient compressor (:mod:`repro_torch.dist.compress`, one scale per
reference leaf: a parameter stacked over its layers), then AdamW, which
updates the parameters and moments in place.  The reference jits the same
pure function; the port runs it eagerly.  ``make_serve_step`` returns
``serve_step(model, token, pos, cache) -> (logits, cache)``, the model's
one-token decode step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.registry import ModelApi, build_model
from ..models.weights import reference_layout
from .optimizer import AdamWConfig, adamw_init, adamw_update

__all__ = ["make_serve_step", "make_train_state", "make_train_step"]


def make_train_state(api: ModelApi, generator: torch.Generator,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A fresh train state: the model drawn from ``generator`` (on
    ``device``) with float32 masters that take gradients, zero moments,
    step 0."""
    dev = resolve_device(device)
    masters = build_model(dataclasses.replace(api.cfg, dtype="float32"))
    model = masters.init(generator, dev)
    for p in model.parameters():
        p.requires_grad_(True)
    params = dict(model.named_parameters())
    return {"model": model, "opt": adamw_init(params, opt_cfg),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(api: ModelApi, opt_cfg: AdamWConfig, grad_accum: int = 1,
                    compressor: Optional[Any] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``; ``batch``
    is a dict of tensors on the model's device, split along axis 0 into
    ``grad_accum`` microbatches."""

    def grads_of(model, params, batch):
        loss, metrics = api.loss(model, batch)
        gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), gs)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def compute_grads(model, params, batch):
        if grad_accum == 1:
            return grads_of(model, params, batch)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=next(iter(params.values())).device)
        for i in range(grad_accum):
            mb = {k: x[i * (x.shape[0] // grad_accum):
                       (i + 1) * (x.shape[0] // grad_accum)]
                  for k, x in batch.items()}
            loss, metrics, grads = grads_of(model, params, mb)
            for n, g in grads.items():
                acc[n] += g.float()
            loss_sum = loss_sum + loss
            del grads
        return (loss_sum / grad_accum, metrics,
                {n: g / grad_accum for n, g in acc.items()})

    def train_step(state, batch):
        model = state["model"]
        params = dict(model.named_parameters())
        loss, metrics, grads = compute_grads(model, params, batch)
        if compressor is not None:
            # one scale per reference leaf (a parameter stacked over layers)
            grads, state = compressor.apply(grads, state, reference_layout(model))
        _, opt, info = adamw_update(opt_cfg, grads, state["opt"], params)
        new_state = dict(state)
        new_state.update(opt=opt, step=state["step"] + 1)
        return new_state, {"loss": loss, **metrics, **info}

    return train_step


def make_serve_step(api: ModelApi):
    """Returns ``serve_step(model, token, pos, cache) -> (logits, cache)``."""

    def serve_step(model, token, pos, cache):
        return api.decode_step(model, token, pos, cache)

    return serve_step
