"""Gradient of ``flash_attention``: forward and backward by the kernels on
the card, the plain versions on the CPU.

:class:`FlashAttention` is the ``torch.autograd.Function`` behind
:func:`~.ops.flash_attention`.  Its forward is the CUDA kernel on a CUDA
tensor (either route, as :func:`~.kernel.route` picks) and the plain
version on the CPU; on ``meta`` tensors (the dry-run) it returns an empty
output and adds the kernel's work to ``kernels.work``'s counter (and its
backward the backward's, ``attention_bwd_work``).  It saves ``q, k, v``
and the output, and on the tensor-core route, when a gradient will be
taken (``training``), the rows' log-sum-exp that the forward kernel then
writes.  Its backward follows the forward's route, decided before launch
from dtypes, shapes and strides (:func:`~.backward.backward_route`): the
tensor-core route's inputs go to the hand-written backward kernel
(:func:`~.backward.flash_attention_bwd_cuda`, bf16 ``wgmma``), everything
else (the CPU; float32 and float64 on the card; bf16 that TMA cannot
read) to :func:`flash_attention_bwd`, PyTorch ops, the plain version: the
gradient that autodiff of the reference's chunked XLA path computes,
written out:

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
``(B, Hq, Sq, Skv)`` tensor is ever live.  Nothing falls back from the
kernel to the ops: a launch that fails raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.profiler

from .. import work
from .backward import backward_route, flash_attention_bwd_cuda
from .kernel import flash_attention_cuda
from .ref import check_shapes, flash_attention_ref

__all__ = ["FlashAttention", "flash_attention_bwd", "row_lse", "row_span"]

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


def _key_chunks(b, hq, sq, skv, causal, window, dev):
    """``(lo, hi, r0, r1, vis)`` of each key chunk that some row sees: the
    keys ``[lo, hi)``, the rows ``[r0, r1)`` that see one of them and
    their ``(r1 - r0, hi - lo)`` visibility mask."""
    off = skv - sq
    pos = torch.arange(skv, device=dev)
    kc = max(16, min(skv, _SCORE_ELEMS // max(1, b * hq * sq)))
    chunks = []
    for lo in range(0, skv, kc):
        hi = min(skv, lo + kc)
        r0, r1 = row_span(lo, hi, sq, off, causal, window)
        if r0 < r1:
            rows = torch.arange(r0 + off, r1 + off, device=dev)  # their positions
            chunks.append((lo, hi, r0, r1, _visible(rows, pos[lo:hi], causal, window)))
    return chunks


def _scores(qs, kf, lo, hi, r0, r1, vis):
    """The chunk's masked scores ``(B, Hkv, G, r1 - r0, hi - lo)``."""
    s = qs[:, :, :, r0:r1] @ kf[:, :, None, lo:hi].transpose(-1, -2)
    return s.masked_fill(~vis, -math.inf)


def _lse_pass(qs, kf, chunks):
    """Pass 1: the row log-sum-exp over the visible keys, key chunk by key
    chunk (running max and sum); 0 for a row that sees no key."""
    m = torch.full(qs.shape[:-1], -math.inf, dtype=qs.dtype, device=qs.device)
    l = torch.zeros_like(m)
    for lo, hi, r0, r1, vis in chunks:
        s = _scores(qs, kf, lo, hi, r0, r1, vis)
        m_old = m[..., r0:r1]
        m_new = torch.maximum(m_old, s.amax(-1))
        m_safe = torch.where(m_new == -math.inf, 0.0, m_new)
        l[..., r0:r1] = (l[..., r0:r1] * torch.exp(m_old - m_safe)
                         + torch.exp(s - m_safe[..., None]).sum(-1))
        m[..., r0:r1] = m_new
    return torch.where(l > 0, m + torch.log(l), 0.0)


def row_lse(q, k, causal: bool = True, window: Optional[int] = None,
            scale: Optional[float] = None) -> torch.Tensor:
    """``(B, Hq, Sq)`` row log-sum-exp as :func:`flash_attention_bwd`'s
    first pass computes it (0 for a row that sees no key)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qs = (q.to(acc) * scale).reshape(b, hkv, hq // hkv, sq, d)
    chunks = _key_chunks(b, hq, sq, skv, causal, window, q.device)
    return _lse_pass(qs, k.to(acc), chunks).reshape(b, hq, sq)


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
    qs = (q.to(acc) * scale).reshape(b, hkv, g, sq, d)
    do = d_out.to(acc).reshape(b, hkv, g, sq, d)
    delta = (do * out.to(acc).reshape(b, hkv, g, sq, d)).sum(-1)  # (B,Hkv,G,Sq)
    kf, vf = k.to(acc), v.to(acc)
    chunks = _key_chunks(b, hq, sq, skv, causal, window, dev)
    lse = _lse_pass(qs, kf, chunks)

    # pass 2: the gradients, key chunk by key chunk
    dq = torch.zeros_like(qs)
    dk = torch.zeros((b, hkv, skv, d), dtype=acc, device=dev)
    dv = torch.zeros((b, hkv, skv, d), dtype=acc, device=dev)
    for lo, hi, r0, r1, vis in chunks:
        s = _scores(qs, kf, lo, hi, r0, r1, vis)
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
    """The kernel forward; the backward kernel after a tensor-core forward,
    :func:`flash_attention_bwd` after any other.  ``training``: a gradient
    will be taken (the caller's grad mode, which a Function's forward does
    not see), so the tensor-core forward also writes the log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, training=False):
        lse = None
        if q.device.type == "cuda":
            if training and backward_route(q, k, v) == "tensor_core":
                out, lse = flash_attention_cuda(q, k, v, causal, window, scale,
                                                return_lse=True)
            else:
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
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "meta":   # the dry-run: the backward's work, counted
            causal, window, _ = ctx.mask
            b, hq, sq, d = q.shape
            work.record("flash_attention_backward", *work.attention_bwd_work(
                b, hq, k.shape[1], sq, k.shape[2], d, causal, window,
                q.element_size()))
            return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
                    None, None, None, None)
        # a named span, so that a profile can attribute the device time
        with torch.profiler.record_function("flash_attention.backward"):
            if lse is not None:  # the forward took the tensor-core route
                dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, d_out, lse, *ctx.mask)
            else:
                dq, dk, dv = flash_attention_bwd(q, k, v, out, d_out, *ctx.mask)
        return dq, dk, dv, None, None, None, None
