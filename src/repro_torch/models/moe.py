"""Mixture-of-Experts layer of the port: the reference's
``models/moe.py``, its single-device path (every expert local) and its
expert-parallel path over a mesh.

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

Over a mesh (``dist.logical.use_mesh``) :func:`moe_apply` takes the
reference's expert-parallel path, its ``shard_map`` written with
``local_map``.  The axes come from the active rules, so an ``axis_rules``
override steers it: "experts" names the expert-parallel axis (``"model"``
by default), "batch" and "embed" the dp and FSDP axes.  Each rank holds
``E_l = E / n_model`` experts, from ``e0 = rank · E_l``, gathered whole
over the FSDP axes; it routes its dp shard's tokens (a batch that does
not divide dp stays whole on every rank) with a capacity counted over
those **local** tokens, dispatches the assignments to its own experts and
drops the rest; the partial outputs are summed over "model" in rank
order (:class:`_OrderedSum`) and the aux loss is averaged over dp.  Where
the rules give "experts" no mesh axis, every rank runs all experts on all
tokens, as the single-device path does.

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
from ..dist.logical import current_mesh, current_rules, on_local_blocks, placements
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


def _routed_moe(x: torch.Tensor, router: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor, *, cfg: ModelConfig, e0: int,
                capacity: int, watch: bool):
    """Route ``x (B, S, D)``'s tokens, run the experts ``e0 ..`` held here →
    (y, aux), and when ``watch`` also :class:`Routed`'s fields: dropped, the
    top-k experts (T, k) and the k-th minus (k+1)-th router probability
    (T,)."""
    b, s, d = x.shape
    k = cfg.experts_per_token
    routed = route(x.reshape(b * s, d), router, k)
    y, aux, dropped = _local_moe(x, router, wg, wu, wd, cfg=cfg, e0=e0,
                                 capacity=capacity, routed=routed)
    if not watch:
        return y, aux
    probs, _, top_i = routed
    top = torch.topk(probs, k + 1, dim=-1).values
    return y, aux, dropped, top_i, top[:, k - 1] - top[:, k]


class _OrderedSum(torch.autograd.Function):
    """The sum over one mesh dim of each rank's partial ``t``, added in
    rank order (rank 0's first) after an all-gather, so every rank gets
    the same bits run after run; the gradient of each rank's part is the
    sum's gradient, which every rank holds."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh, dim: str) -> torch.Tensor:
        import torch.distributed._functional_collectives as fc

        # all_gather_single is all_gather_tensor's name from torch 2.13 on
        gather = getattr(fc, "all_gather_single", None) or fc.all_gather_tensor
        j = mesh.mesh_dim_names.index(dim)
        n = mesh.size(j)
        parts = fc.wait_tensor(gather(t.contiguous(), 0, (mesh, j)))
        parts = parts.view(n, *t.shape)
        out = parts[0]
        for i in range(1, n):
            out = out + parts[i]
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None, None


def _dims(rules, logical: str, names, exclude: Optional[str]) -> Tuple[str, ...]:
    got = rules.mesh_axes(logical, names)
    got = () if got is None else ((got,) if isinstance(got, str) else got)
    return tuple(a for a in got if a != exclude)


def _moe_over_mesh(m: MoE, cfg: ModelConfig, x: torch.Tensor, no_drop: bool, mesh,
                   watch: bool):
    """The expert-parallel path (see the module docstring) →
    :func:`_routed_moe`'s outputs as DTensors."""
    from torch.distributed.tensor import Partial

    rules = current_rules()
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    b, s, _ = x.shape
    e = cfg.n_experts
    mdl = rules.mesh_axes("experts", names)
    if not isinstance(mdl, str):
        mdl = None                                   # every expert on every rank
    n_model = sizes[mdl] if mdl else 1
    if e % n_model:
        raise ValueError(f"{e} experts not divisible by {mdl}={n_model}")
    el = e // n_model
    dp = _dims(rules, "batch", names, mdl) if mdl else ()
    n_dp = 1
    for a in dp:
        n_dp *= sizes[a]
    if b % n_dp:
        # batch not divisible over dp (batch = 1 long-context decode): the
        # tokens stay whole on every rank
        dp, n_dp = (), 1
    cap = capacity_for(cfg, (b // n_dp) * s, no_drop)
    e0 = mesh.get_local_rank(mdl) * el if mdl else 0

    def pl(*entries):
        return placements(entries, mesh)

    dp_entry = (dp if len(dp) > 1 else dp[0]) if dp else None
    px = pl(dp_entry, None, None)
    pw = pl(mdl, None, None)          # experts over "model", D gathered whole
    repl = pl()
    sums = [Partial("sum") if p.is_replicate() and sizes[a] > 1 else p
            for p, a in zip(repl, names)]
    # aux: each dp shard's own, the same on every model rank; read as a
    # partial sum over both, divided by both counts, it is the dp mean, and
    # its gradient reaches the router once over "model" (whose gradient,
    # through y, is each model rank's part)
    aux_pl = [Partial("sum") if (a in dp or a == mdl) and sizes[a] > 1 else p
              for p, a in zip(repl, names)]

    def shard_fn(x_l, router, wg_l, wu_l, wd_l):
        y, aux, *seen = _routed_moe(x_l, router, wg_l, wu_l, wd_l, cfg=cfg, e0=e0,
                                    capacity=cap, watch=watch)
        if mdl and n_model > 1:
            y = _OrderedSum.apply(y, mesh, mdl)
        return (y, aux / (n_dp * n_model), *seen)

    outs = [px, aux_pl] + ([sums, pl(dp_entry, None), pl(dp_entry)] if watch else [])
    fn = on_local_blocks(shard_fn, (px, repl, pw, pw, pw), outs)
    return fn(x, m.router, *(cast(w, cfg) for w in (m.wg, m.wu, m.wd)))


def moe_apply(m: MoE, cfg: ModelConfig, x: torch.Tensor, no_drop: bool = False,
              mesh: Optional[Any] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) → (y (B, S, D), aux_loss scalar): all experts local, or
    over the active mesh the expert-parallel path.

    ``no_drop=True`` sizes capacity so that no token can overflow (the
    decode path, where dropping would corrupt generation).  The mesh is
    read from ``dist.logical.use_mesh``; ``mesh=``, if given, must be that
    mesh."""
    active = current_mesh()
    if mesh is not None and mesh is not active:
        raise ValueError("moe_apply reads its mesh from dist.logical.use_mesh; "
                         "the mesh= given is not the active one")
    watch = m.monitor is not None
    if active is not None:
        y, aux, *seen = _moe_over_mesh(m, cfg, x, no_drop, active, watch)
    else:
        b, s, _ = x.shape
        y, aux, *seen = _routed_moe(
            x, m.router, *(cast(w, cfg) for w in (m.wg, m.wu, m.wd)), cfg=cfg,
            e0=0, capacity=capacity_for(cfg, b * s, no_drop), watch=watch)
    if watch:
        m.monitor.append(Routed(*seen))
    return y, aux
