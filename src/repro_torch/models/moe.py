"""Mixture-of-Experts layer of the port: the single-device path of the
reference's ``models/moe.py`` (every expert local).

Routing: softmax over the router's logits (float32), top-k experts per
token, weights renormalised over the k.  Dispatch is capacity-bounded:
the ``T·k`` assignments are sorted by expert (stable, so each expert's
tokens keep their order), an assignment's rank inside its expert is its
slot, and ranks at or past the capacity ``C`` are dropped (switch-style)
and counted.  Each expert runs a dense SwiGLU over its ``(C, D)`` slot
buffer; the combine sums, for each token, the weighted outputs of its k
assignments (a dropped one adds zero).

``C = max(1, int(capacity_factor · T · k / E))`` over all ``T = B·S``
tokens, pads included, as the reference counts them; ``no_drop=True``
sizes ``C = T`` so no token can overflow (the decode path).  The
reference's ``.at[].set`` into the discard row is ``index_put_``.  Its
``.at[].add`` combine is a gather of each token's k slots, summed over the
k in rank order: a scatter-add (``index_add_``) adds in the card's atomic
order, so the same batch could round to other bf16 outputs run to run;
the gather gives one answer.

The expert-parallel path over a mesh (``shard_map`` in the reference) is
ROADMAP Queue 1 item 10: :func:`moe_apply` raises when given a mesh.

Dropped assignments are monitoring, as in the reference: inside
``with monitor(model) as calls:`` every :func:`moe_apply` of one of
``model``'s MoE layers appends a :class:`Routed` record of the routing it
dispatched (0-d device tensors, read by the caller after the work) to
``calls``.  Outside it nothing is kept and nothing synchronises.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import _param, cast, compute_dtype, dense_init

__all__ = ["MoE", "Routed", "moe_apply", "moe_init", "monitor", "route"]


class Routed(NamedTuple):
    """One :func:`moe_apply` call as dispatched, for :func:`monitor`."""

    dropped: torch.Tensor  # 0-d: assignments past the capacity
    top_i: torch.Tensor    # (T, k) the experts each token was sent to
    margin: torch.Tensor   # (T,) k-th minus (k+1)-th router probability


class MoE(nn.Module):
    """``router (D, E)`` float32; experts ``wg, wu (E, D, F)``,
    ``wd (E, F, D)`` in the compute dtype."""

    def __init__(self, router, wg, wu, wd):
        super().__init__()
        self.router, self.wg, self.wu, self.wd = map(_param, (router, wg, wu, wd))
        self.monitor: Optional[List[Routed]] = None  # set by monitor()


@contextlib.contextmanager
def monitor(model: nn.Module) -> Iterator[List[Routed]]:
    """Collect a :class:`Routed` record of every :func:`moe_apply` call of
    ``model``'s MoE layers (``model`` itself included) inside the ``with``
    block, in call order; ``int(sum(c.dropped for c in calls))`` is the
    total dropped."""
    calls: List[Routed] = []
    layers = [m for m in model.modules() if isinstance(m, MoE)]
    for m in layers:
        m.monitor = calls
    try:
        yield calls
    finally:
        for m in layers:
            m.monitor = None


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


def route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Tokens ``xf (T, D)`` → (softmax probabilities (T, E) float32, the
    top-k weights renormalised over the k (T, k), the top-k experts
    (T, k))."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)   # (T, E)
    top_w, top_i = torch.topk(probs, k, dim=-1)                  # (T, k)
    return probs, top_w / torch.sum(top_w, dim=-1, keepdim=True), top_i


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
    routed: Optional[Tuple[torch.Tensor, ...]] = None,  # route()'s, if taken
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

    probs, top_w, top_i = route(xf, router, k) if routed is None else routed

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
    # row gathers through F.embedding: a backward that sums each row's
    # gradients in one order, run after run (see common.embed_apply)
    xe = F.embedding(tok_buf, xpad)                              # (E_l, C, D)

    g = F.silu(torch.bmm(xe, wg))
    u = torch.bmm(xe, wu)
    ye = torch.bmm(g * u, wd)
    ye = ye * w_buf[..., None].to(cdt)

    # each assignment's row of the flattened slots, in (token, rank) order;
    # the zero row E_l * C when it was dropped or is another shard's
    dest = torch.where(keep, slot_e * capacity + slot_c, el * capacity)
    src = torch.empty_like(dest)
    src[order] = dest
    yflat = torch.cat([ye.reshape(el * capacity, d), ye.new_zeros((1, d))], dim=0)
    y = F.embedding(src, yflat).view(t, k, d).sum(dim=1)

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
    b, s, d = x.shape
    k = cfg.experts_per_token
    routed = route(x.reshape(b * s, d), m.router, k)
    y, aux, dropped = _local_moe(x, m.router, *(cast(w, cfg) for w in (m.wg, m.wu, m.wd)),
                                 cfg=cfg, e0=0,
                                 capacity=capacity_for(cfg, b * s, no_drop),
                                 routed=routed)
    if m.monitor is not None:
        probs, _, top_i = routed
        top = torch.topk(probs, k + 1, dim=-1).values
        m.monitor.append(Routed(dropped, top_i, top[:, k - 1] - top[:, k]))
    return y, aux
