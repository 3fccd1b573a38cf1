"""AdamW and its learning-rate schedule, the port of
``repro.train.optimizer``.

The optimizer works on named tensors: ``params``, the gradients and the
moments are ``{parameter name: tensor}`` dicts (a module's
``named_parameters``).  The state mirrors the parameters: ``m`` (float32,
or bfloat16 with ``m_dtype="bfloat16"``), ``v`` (float32) and ``count``
(an int32 scalar).  The arithmetic and its order are the reference's:
global-norm clipping with ``+1e-9``, bias corrections from ``count``, and
the decoupled decay ``p - lr * (step + wd * p)``.  ``torch.optim.AdamW``
applies its decay as ``p * (1 - lr * wd)`` before the step, which rounds
otherwise, so the update is written out here.  Unlike the reference's
functional update, :func:`adamw_update` writes the new parameters and
moments into their tensors in place (no second copy of the state).  The
update is plain per-tensor arithmetic and ``copy_`` (no ``_foreach_*``
call), each of which DTensor shards, so the same code updates a state
laid out over a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm"]

Named = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # first moment in bfloat16 (a smoothed gradient tolerates it); v stays
    # float32: 6 bytes of optimizer state per parameter instead of 8
    m_dtype: str = "float32"


def cosine_schedule(cfg: AdamWConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``lr`` over ``warmup_steps``, then a cosine down to
    ``min_lr_frac * lr`` at ``total_steps``; float32 arithmetic."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        prog = torch.clamp(
            (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
            0.0, 1.0,
        )
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
        return cfg.lr * warm * frac

    return lr


def global_norm(tensors: Named) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, in float32."""
    return torch.sqrt(
        sum(torch.sum(torch.square(x.float())) for x in tensors.values())
    )


def adamw_init(params: Named, cfg: Optional[AdamWConfig] = None) -> dict:
    """Zero moments beside each parameter and ``count`` 0."""
    m_dt = torch.bfloat16 if cfg and cfg.m_dtype == "bfloat16" else torch.float32
    device = next(iter(params.values())).device
    # zeros_like: a DTensor parameter gets moments laid out as it is
    return {
        "m": {n: torch.zeros_like(p, dtype=m_dt, requires_grad=False)
              for n, p in params.items()},
        "v": {n: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
              for n, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Named, opt_state: dict,
                 params: Named) -> Tuple[Named, dict, dict]:
    """One AdamW step with global-norm clipping → ``(params, opt_state,
    {"lr", "grad_norm"})``.  The tensors of ``params``, ``m`` and ``v`` are
    updated in place and returned; ``count`` is a new tensor."""
    count = opt_state["count"] + 1
    lr = cosine_schedule(cfg)(count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c = count.float()
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    ms, vs = opt_state["m"], opt_state["v"]
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = ms[name], vs[name]
        m.copy_((b1 * m.float() + (1 - b1) * g).to(m.dtype))
        v.copy_(b2 * v + (1 - b2) * torch.square(g))
        step = (m.float() / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.float()
        p.copy_((pf - lr * (step + cfg.weight_decay * pf)).to(p.dtype))
    return params, {"m": ms, "v": vs, "count": count}, {"lr": lr, "grad_norm": gnorm}
