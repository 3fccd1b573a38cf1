"""Gradient of ``flash_attention``: forward by the kernel, backward in
PyTorch ops.

:class:`FlashAttention` is the ``torch.autograd.Function`` behind
:func:`~.ops.flash_attention`.  Its forward is the CUDA kernel on a CUDA
tensor (either route, as :func:`~.kernel.route` picks) and the plain
version on the CPU; on ``meta`` tensors (the dry-run) it returns an empty
output and adds the kernel's work to ``kernels.work``'s counter (and its
backward the backward's, ``attention_bwd_work``).  It saves ``q, k, v``
and the output.  Its backward,
:func:`flash_attention_bwd`, is the gradient that autodiff of the
reference's chunked XLA path computes, written out:

* the row log-sum-exp ``lse`` of ``S = (q * scale) k^T`` over the visible
  keys is recomputed, key chunk by key chunk (running max and sum);
* then, per key chunk: ``P = exp(S - lse)`` on the visible entries (0
  elsewhere), ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP - D)`` with
  ``D = rowsum(dO * O)``, ``dQ += dS K scale``, ``dK = dS^T (q * scale)``.

Only the query rows that see some key of a chunk take part in it (a
causal mask halves the work).  The masks are the forward's: causal with
the queries the last ``Sq`` positions of the keys (``off = Skv - Sq``),
the window, and GQA (query head ``h`` reads KV head ``h // G``; ``dK`` and
``dV`` sum over the ``G`` query heads of a group).  A row that sees no key
has output 0 and gets gradient 0.  Arithmetic is float32 (float64 for
float64 inputs) through ``torch.matmul``, with at most ``_SCORE_ELEMS``
elements in a chunk's ``(B, Hkv, G, rows, keys)`` score block, so no
``(B, Hq, Sq, Skv)`` tensor is ever live.  A hand-written backward kernel
is a later step (ROADMAP Queue 2 F).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.profiler

from .. import work
from .kernel import flash_attention_cuda
from .ref import check_shapes, flash_attention_ref

__all__ = ["FlashAttention", "flash_attention_bwd", "row_span"]

_SCORE_ELEMS = 1 << 26  # elements of one chunk's score block (256 MiB float32)


def row_span(lo: int, hi: int, sq: int, off: int, causal: bool,
             window: Optional[int]):
    """Query rows ``[r0, r1)`` that see at least one key of ``[lo, hi)``
    (row ``i`` sits at position ``i + off``; ``off`` < 0 when ``Sq >
    Skv``).  Without the causal mask no row is too early for a key."""
    r0 = max(0, min(sq, lo - off)) if causal else 0
    p_max = hi - 2 + window if window is not None else sq + off
    return r0, max(0, min(sq, p_max - off + 1))


def _visible(rows: torch.Tensor, keys: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    vis = torch.ones((rows.numel(), keys.numel()), dtype=torch.bool,
                     device=rows.device)
    if causal:
        vis &= keys[None, :] <= rows[:, None]
    if window is not None:
        vis &= keys[None, :] > rows[:, None] - window
    return vis


def flash_attention_bwd(q, k, v, out, d_out, causal: bool = True,
                        window: Optional[int] = None,
                        scale: Optional[float] = None):
    """``(dq, dk, dv)`` of ``flash_attention(q, k, v, causal, window,
    scale)`` whose output was ``out``, for the output gradient ``d_out``;
    each in its input's dtype."""
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    dev = q.device
    off = skv - sq
    qs = (q.to(acc) * scale).reshape(b, hkv, g, sq, d)
    do = d_out.to(acc).reshape(b, hkv, g, sq, d)
    delta = (do * out.to(acc).reshape(b, hkv, g, sq, d)).sum(-1)  # (B,Hkv,G,Sq)
    kf, vf = k.to(acc), v.to(acc)
    pos = torch.arange(skv, device=dev)
    kc = max(16, min(skv, _SCORE_ELEMS // max(1, b * hq * sq)))
    chunks = []
    for lo in range(0, skv, kc):
        hi = min(skv, lo + kc)
        r0, r1 = row_span(lo, hi, sq, off, causal, window)
        if r0 < r1:
            rows = torch.arange(r0 + off, r1 + off, device=dev)  # their positions
            vis = _visible(rows, pos[lo:hi], causal, window)
            chunks.append((lo, hi, r0, r1, vis))

    def scores(lo, hi, r0, r1, vis):
        s = qs[:, :, :, r0:r1] @ kf[:, :, None, lo:hi].transpose(-1, -2)
        return s.masked_fill(~vis, -math.inf)             # (B,Hkv,G,n,kc)

    # pass 1: the row log-sum-exp over the visible keys
    m = torch.full((b, hkv, g, sq), -math.inf, dtype=acc, device=dev)
    l = torch.zeros((b, hkv, g, sq), dtype=acc, device=dev)
    for lo, hi, r0, r1, vis in chunks:
        s = scores(lo, hi, r0, r1, vis)
        m_old = m[..., r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        l[..., r0:r1] = (l[..., r0:r1] * torch.exp(m_old - m_safe)
                         + torch.exp(s - m_safe[..., None]).sum(-1))
        m[..., r0:r1] = m_new
    lse = torch.where(l > 0, m + torch.log(l), 0.0)        # 0: the row sees no key
    del m, l

    # pass 2: the gradients, key chunk by key chunk
    dq = torch.zeros_like(qs)
    dk = torch.zeros((b, hkv, skv, d), dtype=acc, device=dev)
    dv = torch.zeros((b, hkv, skv, d), dtype=acc, device=dev)
    for lo, hi, r0, r1, vis in chunks:
        s = scores(lo, hi, r0, r1, vis)
        p = torch.where(vis, torch.exp(s - lse[..., r0:r1, None]), 0.0)
        del s
        doc = do[:, :, :, r0:r1]
        dv[:, :, lo:hi] = (p.transpose(-1, -2) @ doc).sum(2)
        dp = doc @ vf[:, :, None, lo:hi].transpose(-1, -2)
        ds = p * (dp - delta[..., r0:r1, None])
        del p, dp
        dq[:, :, :, r0:r1] += ds @ kf[:, :, None, lo:hi]
        dk[:, :, lo:hi] = (ds.transpose(-1, -2) @ qs[:, :, :, r0:r1]).sum(2)
        del ds
    dq = (dq * scale).reshape(b, hq, sq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The kernel forward, :func:`flash_attention_bwd` backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cuda":
            out = flash_attention_cuda(q, k, v, causal, window, scale)
        elif all(t.device.type == "cpu" for t in (q, k, v)):
            out = flash_attention_ref(q, k, v, causal, window, scale)
        elif all(t.device.type == "meta" for t in (q, k, v)):
            # the dry-run: shapes only, and the kernel's work on its counter
            b, hq, sq, d = q.shape
            work.record("flash_attention", *work.attention_work(
                b, hq, k.shape[1], sq, k.shape[2], d, causal, window,
                q.element_size()))
            out = torch.empty_like(q)
        else:
            raise ValueError(
                f"flash_attention: unsupported devices {q.device} / {k.device} / "
                f"{v.device}"
            )
        ctx.save_for_backward(q, k, v, out)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        if q.device.type == "meta":   # the dry-run: the backward's work, counted
            causal, window, _ = ctx.mask
            b, hq, sq, d = q.shape
            work.record("flash_attention_backward", *work.attention_bwd_work(
                b, hq, k.shape[1], sq, k.shape[2], d, causal, window,
                q.element_size()))
            return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                    None, None, None)
        # a named span, so that a profile can attribute the device time
        with torch.profiler.record_function("flash_attention.backward"):
            dq, dk, dv = flash_attention_bwd(q, k, v, out, d_out, *ctx.mask)
        return dq, dk, dv, None, None, None
