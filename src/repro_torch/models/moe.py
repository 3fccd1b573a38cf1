"""Mixture-of-Experts layer of the port: the single-device path of the
reference's ``models/moe.py`` (every expert local).

Routing: softmax over the router's logits (float32), top-k experts per
token, weights renormalised over the k.  Dispatch is capacity-bounded:
the ``T·k`` assignments are sorted by expert (stable, so each expert's
tokens keep their order), an assignment's rank inside its expert is its
slot, and ranks at or past the capacity ``C`` are dropped (switch-style)
and counted.  Each expert runs a dense SwiGLU over its ``(C, D)`` slot
buffer; the combine adds each slot's weighted output back into its
token's row.

``C = max(1, int(capacity_factor · T · k / E))`` over all ``T = B·S``
tokens, pads included, as the reference counts them; ``no_drop=True``
sizes ``C = T`` so no token can overflow (the decode path).  The
reference's ``.at[].set`` into the discard row is ``index_put_``, and its
``.at[].add`` combine ``index_add_`` on a ``(T + 1, D)`` buffer.

The expert-parallel path over a mesh (``shard_map`` in the reference) is
ROADMAP Queue 1 item 10: :func:`moe_apply` raises when given a mesh.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import _param, compute_dtype, dense_init

__all__ = ["MoE", "moe_apply", "moe_init"]


class MoE(nn.Module):
    """``router (D, E)`` float32; experts ``wg, wu (E, D, F)``,
    ``wd (E, F, D)`` in the compute dtype."""

    def __init__(self, router, wg, wu, wd):
        super().__init__()
        self.router, self.wg, self.wu, self.wd = map(_param, (router, wg, wu, wd))


def moe_init(cfg: ModelConfig, generator: torch.Generator) -> MoE:
    cdt = compute_dtype(cfg)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s = 1.0 / math.sqrt(d)
    return MoE(
        router=dense_init((d, e), generator, scale=0.02),
        wg=dense_init((e, d, f), generator, scale=s).to(cdt),
        wu=dense_init((e, d, f), generator, scale=s).to(cdt),
        wd=dense_init((e, f, d), generator, scale=1.0 / math.sqrt(f)).to(cdt),
    )


def _local_moe(
    x_l: torch.Tensor,       # (B, S, D)
    router: torch.Tensor,    # (D, E)
    wg: torch.Tensor,        # (E_l, D, F) local experts
    wu: torch.Tensor,
    wd: torch.Tensor,
    *,
    cfg: ModelConfig,
    e0: int,                 # first expert id held here
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dispatch → per-expert SwiGLU → combine → (y (B, S, D), aux loss,
    dropped assignments)."""
    cdt = compute_dtype(cfg)
    bl, s, d = x_l.shape
    e = cfg.n_experts
    el = wg.shape[0]
    k = cfg.experts_per_token
    t = bl * s
    dev = x_l.device
    xf = x_l.reshape(t, d)

    logits = xf.float() @ router.float()                         # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, k, dim=-1)                  # (T, k)
    top_w = top_w / torch.sum(top_w, dim=-1, keepdim=True)       # renorm

    # --- capacity-bounded ranking ------------------------------------------
    flat_i = top_i.reshape(-1)                                   # (T*k,)
    flat_w = top_w.reshape(-1)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_i, stable=True)
    sorted_i = flat_i[order]
    first = torch.searchsorted(sorted_i, torch.arange(e, device=dev))
    rank = torch.arange(t * k, device=dev) - first[sorted_i]

    local_e = sorted_i - e0
    mine = (local_e >= 0) & (local_e < el)
    keep = mine & (rank < capacity)
    slot_e = torch.where(keep, local_e, el)                      # el = discard row
    slot_c = torch.where(keep, rank, 0)
    tok_sorted = flat_tok[order]
    w_sorted = flat_w[order]

    tok_buf = torch.full((el + 1, capacity), t, dtype=torch.long, device=dev)
    tok_buf.index_put_((slot_e, slot_c), torch.where(keep, tok_sorted, t))
    w_buf = torch.zeros((el + 1, capacity), dtype=torch.float32, device=dev)
    w_buf.index_put_((slot_e, slot_c), torch.where(keep, w_sorted, 0.0))
    tok_buf, w_buf = tok_buf[:el], w_buf[:el]

    xpad = torch.cat([xf, xf.new_zeros((1, d))], dim=0)
    xe = xpad[tok_buf]                                           # (E_l, C, D)

    g = F.silu(torch.bmm(xe, wg))
    u = torch.bmm(xe, wu)
    ye = torch.bmm(g * u, wd)
    ye = ye * w_buf[..., None].to(cdt)

    y = torch.zeros((t + 1, d), dtype=cdt, device=dev)
    y.index_add_(0, tok_buf.reshape(-1), ye.reshape(-1, d))
    y = y[:t]

    # --- aux telemetry -------------------------------------------------------
    counts = torch.zeros((e,), dtype=torch.float32, device=dev)
    counts.index_add_(0, flat_i, torch.ones_like(flat_w))
    dispatch_frac = counts / (t * k)                             # f_e
    prob_frac = torch.mean(probs, dim=0)                         # P_e
    aux = e * torch.sum(dispatch_frac * prob_frac)
    dropped = torch.sum(mine & ~keep)
    return y.reshape(bl, s, d), aux, dropped


def capacity_for(cfg: ModelConfig, t_tokens: int, no_drop: bool = False) -> int:
    """Slots per expert for ``t_tokens`` tokens (the reference's
    ``cap_for``)."""
    if no_drop:
        return t_tokens
    k, e = cfg.experts_per_token, cfg.n_experts
    return max(1, int(cfg.capacity_factor * t_tokens * k / e))


def moe_apply(m: MoE, cfg: ModelConfig, x: torch.Tensor, no_drop: bool = False,
              mesh: Optional[Any] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), aux_loss scalar), all experts local.

    ``no_drop=True`` sizes capacity so that no token can overflow (the
    decode path, where dropping would corrupt generation)."""
    if mesh is not None:
        raise NotImplementedError(
            "moe_apply over a mesh (expert parallelism) is not ported yet "
            "(ROADMAP Queue 1 item 10, the distribution layer)"
        )
    b, s, _ = x.shape
    y, aux, _ = _local_moe(x, m.router, m.wg, m.wu, m.wd, cfg=cfg, e0=0,
                           capacity=capacity_for(cfg, b * s, no_drop))
    return y, aux
