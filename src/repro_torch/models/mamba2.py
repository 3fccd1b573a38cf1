"""Mamba2 mixer (SSD, state-space duality) of the port, the counterpart of
the reference's ``models/mamba2.py``.

Prefill uses the chunked SSD form: inside a chunk the outputs are dense
``(Q x Q)`` masked products (``torch.einsum``/``torch.matmul``, as the
reference leaves them to XLA); across chunks the compact ``(H, P, N)``
state follows the sequential recurrence of the ``ssd_scan`` kernel (the
CUDA kernel for a CUDA tensor, the plain version on the CPU).  Decode is
the O(1) recurrent update.

The arithmetic follows the reference step for step: the projections in the
compute dtype, the convolution, the SSD terms and the recurrence in
float32, one cast back to the compute dtype before the gated RMSNorm.
``in_proj`` and ``out_proj`` are stored in the compute dtype (cast once at
load, the values of the reference's ``.astype(cdt)`` at each use);
``conv_w``, ``conv_b``, ``a_log``, ``d_skip``, ``dt_bias`` and ``norm_w``
stay float32, as the reference computes with them.

As in the reference, a right-padded ragged batch builds its final state
over the batch's padded length: the pads of a short prompt are absorbed
into its ``ssm`` state and ``conv`` tail (``mamba_apply`` takes no
lengths).  The port reproduces that.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import flags
from ..configs.base import ModelConfig
from ..dist.logical import constrain, current_mesh, on_local_blocks, resolved_placements
from ..kernels.ssd_scan.ops import ssd_scan
from .common import _param, cast, compute_dtype, dense_init, pad_dim, rmsnorm, tp_input

__all__ = [
    "Mamba2",
    "mamba_apply",
    "mamba_decode",
    "mamba_init",
    "mamba_state_init",
]

State = Dict[str, torch.Tensor]
_NAMES = ("in_proj", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias",
          "norm_w", "out_proj")


def _dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    h = cfg.ssm_heads
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    conv_dim = d_inner + 2 * n            # x, B, C share the conv (n_groups=1)
    return d_inner, h, p, n, conv_dim


class Mamba2(nn.Module):
    """``in_proj (D, 2·d_inner + 2N + H)``, ``conv_w (conv_dim, K)``,
    ``conv_b (conv_dim,)``, ``a_log``, ``d_skip``, ``dt_bias (H,)``,
    ``norm_w (d_inner,)``, ``out_proj (d_inner, D)``."""

    def __init__(self, in_proj, conv_w, conv_b, a_log, d_skip, dt_bias, norm_w,
                 out_proj):
        super().__init__()
        for name, t in zip(_NAMES, (in_proj, conv_w, conv_b, a_log, d_skip,
                                    dt_bias, norm_w, out_proj)):
            setattr(self, name, _param(t))


def mamba_init(cfg: ModelConfig, generator: torch.Generator) -> Mamba2:
    """The reference's distributions, drawn from ``generator`` on its
    device (the numbers differ from ``jax.random``'s)."""
    cdt = compute_dtype(cfg)
    dev = generator.device
    d = cfg.d_model
    d_inner, h, p, n, conv_dim = _dims(cfg)
    d_proj = 2 * d_inner + 2 * n + h      # [z, x, B, C, dt]
    f32 = dict(dtype=torch.float32, device=dev)
    return Mamba2(
        in_proj=dense_init((d, d_proj), generator).to(cdt),
        conv_w=dense_init((conv_dim, cfg.ssm_conv), generator, scale=0.1),
        conv_b=torch.zeros((conv_dim,), **f32),
        a_log=torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        d_skip=torch.ones((h,), **f32),
        dt_bias=torch.log(torch.expm1(torch.full((h,), 1e-2, **f32))),
        norm_w=torch.ones((d_inner,), **f32),
        out_proj=dense_init((d_inner, d), generator,
                            scale=1.0 / math.sqrt(d_inner)).to(cdt),
    )


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_inner, h, p, n, _ = _dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * n]
    dt = proj[..., 2 * d_inner + 2 * n:]
    return z, xbc, dt


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0)
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S: xbc (B, S, C), w (C, K)."""
    k = w.shape[1]
    s = xbc.shape[1]
    pad = pad_dim(xbc, 1, k - 1, 0)
    out = pad[:, :s, :].float() * w[:, 0]
    for i in range(1, k):  # K is tiny (4)
        out = out + pad[:, i: i + s, :].float() * w[:, i]
    return F.silu(out + b).to(xbc.dtype)


def _scan_bh(states: torch.Tensor, chunk_decay: torch.Tensor) -> torch.Tensor:
    """``ssd_scan`` over states ``(B, C, H, P, N)`` and decays ``(B, C, H)``,
    the (B, H) pairs flattened into the kernel's ``BH`` dim →
    prefix states ``(B, C, H, P, N)``."""
    b, nc, h, p, n = states.shape
    states_bh = states.transpose(1, 2).reshape(b * h, nc, p, n)
    decay_bh = chunk_decay.transpose(1, 2).reshape(b * h, nc)
    prefix = ssd_scan(states_bh, decay_bh)             # (B*H, C, P, N)
    return prefix.reshape(b, h, nc, p, n).transpose(1, 2)


def _ssd(xs_c: torch.Tensor, b_c: torch.Tensor, c_c: torch.Tensor,
         dt_c: torch.Tensor, da_c: torch.Tensor, d_skip: torch.Tensor):
    """The SSD of chunked float32 inputs — ``xs_c (B, C, Q, H, P)``,
    ``b_c, c_c (B, C, Q, N)``, ``dt_c, da_c (B, C, Q, H)``, ``d_skip (H,)``
    → (y ``(B, C, Q, H, P)``, the state after the last chunk ``(B, H, P,
    N)``): the intra-chunk products, the chunk states, the inter-chunk
    recurrence (the ``ssd_scan`` kernel) and the inter-chunk output."""
    q = xs_c.shape[2]
    cum = torch.cumsum(da_c, dim=2)                    # (B, C, Q, H)

    # intra-chunk: w[q_, k_] = C_q·B_k · exp(cum_q - cum_k) · dt_k, causal
    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)[:, :, None]  # (B,C,1,Q,Q)
    cum_h = cum.movedim(3, 2)                          # (B, C, H, Q)
    # the mask goes on the exponent, not on the exponential: above the
    # diagonal cum_q - cum_k >= 0 can exceed float32's exp range, and the
    # reference's where(causal, exp(.), 0) then has gradient 0 * inf = NaN
    # (the values are the same: exp(-inf) = 0)
    causal = torch.ones((q, q), dtype=torch.bool, device=xs_c.device).tril()
    dmat = torch.exp(torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :],
                                 -math.inf))
    dt_h = dt_c.movedim(3, 2)                          # (B, C, H, Q)
    w = scores * dmat * dt_h[..., None, :]             # (B, C, H, Q, Q)
    del scores, dmat
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, xs_c)
    del w

    # chunk states: sum_k exp(cum_last - cum_k) · dt_k · X_k ⊗ B_k
    last = cum_h[..., -1:]                             # (B, C, H, 1)
    sw = torch.exp(last - cum_h) * dt_h                # (B, C, H, Q)
    xw = xs_c.permute(0, 1, 3, 4, 2) * sw[:, :, :, None, :]   # (B, C, H, P, Q)
    states = torch.matmul(xw, b_c[:, :, None])         # (B, C, H, P, N)
    del xw

    # inter-chunk recurrence (the ssd_scan kernel)
    chunk_decay = torch.exp(last[..., 0])              # (B, C, H)
    prefix = _scan_bh(states, chunk_decay)             # (B, C, H, P, N)

    # inter-chunk output: y_q += (C_q · prefix) * exp(cum_q)
    edecay = torch.exp(cum_h).movedim(2, 3)            # (B, C, Q, H)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", c_c, prefix) * edecay[..., None]
    y = y_intra + y_inter + d_skip[None, None, None, :, None] * xs_c
    # final state = decay_last * prefix_last + states_last (exact with
    # padding: padded steps were dt = 0 no-ops)
    final = chunk_decay[:, -1][..., None, None] * prefix[:, -1] + states[:, -1]
    return y, final


def _ssd_over_blocks(xs_c, b_c, c_c, dt_c, da_c, d_skip):
    """:func:`_ssd`; under a mesh on each rank's local (batch, heads) block
    (``local_map``), forward and backward.  Its batched products, its
    cumsum (whose gradient is a flip) and the scan's flatten of ``(B, H)``
    into the kernel's ``BH`` dim have no DTensor rule for batch and heads
    sharded over two mesh axes in every torch version the port runs on,
    and every step of it is local to a (batch, head) pair: so the inputs
    are laid out batch over the dp axes and heads over "model" (or whole,
    where they don't divide) and each rank runs its own block; the scan
    never sees a DTensor."""
    mesh = current_mesh()
    if mesh is None:
        return _ssd(xs_c, b_c, c_c, dt_c, da_c, d_skip)
    heads = ("batch", None, None, "ssm_heads")
    p_x = resolved_placements(heads, xs_c.shape, mesh)
    p_bc = resolved_placements(("batch",), b_c.shape, mesh)
    p_dt = resolved_placements(heads, dt_c.shape, mesh)
    p_d = resolved_placements(("ssm_heads",), d_skip.shape, mesh)
    p_final = resolved_placements(("batch", "ssm_heads"), xs_c.shape[:1] + xs_c.shape[3:4],
                                  mesh)
    return on_local_blocks(_ssd, (p_x, p_bc, p_bc, p_dt, p_dt, p_d), [p_x, p_final])(
        xs_c, b_c, c_c, dt_c, da_c, d_skip)


def mamba_apply(m: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence SSD (prefill).  x (B, S, D) → (B, S, D).

    With ``return_state`` also returns the recurrent state after the last
    token, ``{"ssm": (B, H, P, N) float32, "conv": (B, K-1, conv_dim)}``,
    so decode can continue from a prefill.  One ``ssd_scan`` call."""
    cdt = compute_dtype(cfg)
    b, s_true, _ = x.shape
    d_inner, h, p, n, _ = _dims(cfg)
    q = min(cfg.ssm_chunk, s_true)
    pad = (q - s_true % q) % q
    if pad:
        # pad to a chunk multiple; padded steps get dt = 0 below, which
        # makes them exact no-ops on the state (decay e^0 = 1, no input)
        x = pad_dim(x, 1, 0, pad)
    s = s_true + pad
    nc = s // q

    proj = tp_input(x) @ cast(m.in_proj, cfg)
    z, xbc_pre, dt_raw = _split_proj(cfg, proj)
    xbc_pre = constrain(xbc_pre, "batch", "seq", "conv_dim")
    xbc = _causal_conv(xbc_pre, m.conv_w, m.conv_b)
    xs = xbc[..., :d_inner].reshape(b, s, h, p)
    bmat = xbc[..., d_inner: d_inner + n]              # (B, S, N)
    cmat = xbc[..., d_inner + n:]                      # (B, S, N)

    dt = _softplus(dt_raw.float() + m.dt_bias)         # (B, S, H)
    if pad:
        valid = (torch.arange(s, device=x.device) < s_true)[None, :, None]
        dt = dt * valid
    a = -torch.exp(m.a_log)                            # (H,) negative
    da = dt * a                                        # (B, S, H) <= 0

    xs_c = xs.reshape(b, nc, q, h, p).float()
    b_c = bmat.reshape(b, nc, q, n).float()
    c_c = cmat.reshape(b, nc, q, n).float()
    y, final = _ssd_over_blocks(xs_c, b_c, c_c, dt.reshape(b, nc, q, h),
                                da.reshape(b, nc, q, h), m.d_skip)
    y = y.reshape(b, s, d_inner).to(cdt)

    # gated RMSNorm then out projection
    y = rmsnorm(y * F.silu(z), m.norm_w, cfg.norm_eps)
    out = y @ cast(m.out_proj, cfg)
    if pad:
        out = out[:, :s_true]
    out = constrain(out, *flags.residual_axes())
    if not return_state:
        return out
    # a copy: a view would keep the whole (B, S, d_proj) projection alive
    conv_tail = xbc_pre[:, s_true - (cfg.ssm_conv - 1): s_true, :].clone()
    return out, {"ssm": final, "conv": conv_tail}


def mamba_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> State:
    d_inner, h, p, n, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((batch, h, p, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def mamba_decode(m: Mamba2, cfg: ModelConfig, x: torch.Tensor,
                 state: State) -> Tuple[torch.Tensor, State]:
    """One-token recurrent step.  x (B, 1, D) → ((B, 1, D), new state)."""
    cdt = compute_dtype(cfg)
    b = x.shape[0]
    d_inner, h, p, n, _ = _dims(cfg)
    proj = tp_input(x)[:, 0] @ cast(m.in_proj, cfg)                         # (B, d_proj)
    z, xbc_new, dt_raw = _split_proj(cfg, proj)

    # conv ring: state["conv"] (B, K-1, conv_dim) holds the last K-1 inputs
    conv_in = torch.cat([state["conv"], xbc_new[:, None, :]], dim=1)  # (B, K, conv_dim)
    xbc = torch.einsum("bkc,ck->bc", conv_in.float(), m.conv_w)
    xbc = F.silu(xbc + m.conv_b).to(cdt)
    new_conv = conv_in[:, 1:].clone()

    xs = xbc[:, :d_inner].reshape(b, h, p).float()
    bvec = xbc[:, d_inner: d_inner + n].float()        # (B, N)
    cvec = xbc[:, d_inner + n:].float()

    dt = _softplus(dt_raw.float() + m.dt_bias)         # (B, H)
    a = -torch.exp(m.a_log)
    decay = torch.exp(dt * a)                          # (B, H)

    inject = (dt[:, :, None] * xs)[..., None] * bvec[:, None, None, :]
    ssm = state["ssm"] * decay[..., None, None] + inject  # (B, H, P, N)
    y = torch.einsum("bn,bhpn->bhp", cvec, ssm) + m.d_skip[None, :, None] * xs
    y = y.reshape(b, d_inner).to(cdt)
    y = rmsnorm(y * F.silu(z), m.norm_w, cfg.norm_eps)
    out = (y @ cast(m.out_proj, cfg))[:, None, :]
    return out, {"ssm": ssm, "conv": new_conv}
