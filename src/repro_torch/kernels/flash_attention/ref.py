"""Plain PyTorch version of the ``flash_attention`` kernel.

Forward attention with causal and/or sliding-window masks and grouped KV
heads, at the layout of the reference package's kernel: ``q (B, Hq, Sq,
D)`` against ``k, v (B, Hkv, Skv, D)`` → ``(B, Hq, Sq, D)`` in q's dtype.

* Queries are the last ``Sq`` positions of the key stream: row ``i`` sits
  at position ``i + Skv - Sq`` (prefill has ``Sq == Skv``).
* ``causal``: key ``j`` is visible to a query at position ``p`` when
  ``j <= p``; ``window``: when ``j > p - window``.
* Query head ``h`` reads KV head ``h // (Hq // Hkv)``.
* Arithmetic is float32 (float64 for float64 inputs, which the gradient
  checks use): ``s = (q * scale) . k`` with the masked entries set to
  ``-1e30``, ``p = exp(s - max s) * visible``, ``out = p v / sum p``.
* A row that sees no key outputs 0, as the Pallas kernel does (its
  ``safe_l``) and the reference's default chunked path does.  The
  reference's unblocked ``flash_attention_ref`` gives such a row the mean
  of V instead; the two agree wherever every row sees a key.

Queries are taken in row blocks so that the ``(B, Hq, rows, Skv)`` score
block stays under ``_SCORE_ELEMS`` elements.  Runs on any device; the CPU
tests and the CPU model path use it, and on the card it is the yardstick
that the CUDA kernel is held to, through :func:`bound_excess`, and that
the gradients are held to, through :func:`grad_bound_excess`.
:func:`attention_lse_ref` is the plain version of the row log-sum-exp
that the tensor-core forward writes for the backward kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BF16_U", "BOUND_ATOL", "LSE_RTOL", "NEG_INF", "attention_lse_ref",
           "bound_excess", "check_shapes", "flash_attention_ref", "grad_bound_excess",
           "lse_excess"]

NEG_INF = -1e30
BF16_U = 2.0 ** -8   # bfloat16's unit roundoff (8 significant bits)
BOUND_ATOL = 1e-4    # float32 arithmetic (the f32 card tests agree in 2e-5)
_SCORE_ELEMS = 1 << 28  # float32 scores per row block (1 GiB)
# the tensor-core forward's log-sum-exp against attention_lse_ref: float32
# sums of up to a few thousand terms in another order and the MUFU exp2's
# 2^-22 relative error move it by a few ulps of its magnitude
LSE_RTOL = 1e-5


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(B, Hq, Hkv, Sq, Skv, D)`` of a valid call; raises otherwise."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"q, k, v must be 4-D (B, H, S, D), got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}"
        )
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    return b, hq, hkv, sq, skv, d


def _row_blocks(q, k, scale, causal, window):
    """``(lo, hi, s, vis)`` for blocks of query rows: the block's scaled
    scores ``s (B, Hkv, G, n, Skv)`` in float32 (float64 for float64 q) and
    its ``(n, Skv)`` visibility mask, with ``B Hq n Skv`` under
    ``_SCORE_ELEMS``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    dev = q.device
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = k.to(acc)
    k_pos = torch.arange(skv, device=dev)
    rows = max(1, _SCORE_ELEMS // max(1, b * hq * skv))
    for lo in range(0, sq, rows):
        hi = min(sq, lo + rows)
        n = hi - lo
        qf = q[:, :, lo:hi].to(acc) * scale                    # (B, Hq, n, D)
        s = torch.matmul(qf.reshape(b, hkv, g * n, d), kf.transpose(2, 3))
        q_pos = torch.arange(lo, hi, device=dev)[:, None] + (skv - sq)
        vis = torch.ones((n, skv), dtype=torch.bool, device=dev)
        if causal:
            vis &= k_pos[None, :] <= q_pos
        if window is not None:
            vis &= k_pos[None, :] > q_pos - window
        yield lo, hi, s.reshape(b, hkv, g, n, skv), vis


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``(B, Hq, Sq, D)`` attention output in q's dtype; see the module."""
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    g = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    vf = v.to(acc)
    out = torch.empty((b, hq, sq, d), dtype=acc, device=q.device)
    for lo, hi, s, vis in _row_blocks(q, k, scale, causal, window):
        n = hi - lo
        s = s.masked_fill(~vis, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * vis
        den = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.reshape(b, hkv, g * n, skv), vf)
        o = o.reshape(b, hkv, g, n, d) / torch.where(den > 0, den, 1.0)
        out[:, :, lo:hi] = o.reshape(b, hq, n, d)
    return out.to(q.dtype)


def attention_lse_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """``(B, Hq, Sq)`` row log-sum-exp ``ln sum_j exp(scale q_i . k_j)`` over
    the visible keys, in float32 (float64 for float64 inputs): the natural
    log, as the tensor-core forward writes it with ``return_lse``, and
    ``+inf`` for a row that sees no key (its backward ``P`` is then 0).
    ``v`` only shapes the call as the kernel's (it is checked, not read)."""
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    out = torch.empty((b, hq, sq), dtype=acc, device=q.device)
    for lo, hi, s, vis in _row_blocks(q, k, scale, causal, window):
        s = s.masked_fill(~vis, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        den = (torch.exp(s - m) * vis).sum(dim=-1)
        lse = torch.where(den > 0, m[..., 0] + torch.log(den), torch.inf)
        out[:, :, lo:hi] = lse.reshape(b, hq, hi - lo)
    return out


def bound_excess(
    got: torch.Tensor,
    ref: torch.Tensor,
    abs_v_ref: Optional[torch.Tensor] = None,
) -> float:
    """Worst ``|got - ref| / (u |ref| + u A + atol)`` over all elements:
    above 1 is outside the bound.

    ``ref`` is this module's float32 output on the same values; ``u`` is
    :data:`BF16_U`, ``atol`` :data:`BOUND_ATOL`.  Without ``abs_v_ref``
    (``A`` = 0) the bound allows the bf16 output cast only.  With
    ``abs_v_ref`` = ``flash_attention_ref(q, k, v.abs())`` it also allows a
    kernel that rounds P to bf16 before the P·V product (the tensor-core
    route): each ``p_j`` moves by at most ``u p_j``, so the output moves by
    at most ``u sum_j p_j |v_j| / l = u A``.
    """
    allow = BF16_U * ref.abs() + BOUND_ATOL
    if abs_v_ref is not None:
        allow = allow + BF16_U * abs_v_ref
    return float(((got.float() - ref).abs() / allow).max())


def lse_excess(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst ``|got - ref| / (LSE_RTOL (1 + |ref|))`` over the rows that
    see a key (above 1 is outside), or ``inf`` unless ``got`` is ``+inf``
    exactly on the rows where :func:`attention_lse_ref` is."""
    seen = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), seen) or not bool((got[~seen] > 0).all()):
        return float("inf")
    if not bool(seen.any()):
        return 0.0
    err = (got[seen].double() - ref[seen].double()).abs()
    return float((err / (LSE_RTOL * (1 + ref[seen].double().abs()))).max())


def _rounding_terms(q, k, v, d_out, out, causal, window, scale):
    """``(sum_j |dS_ij| |k_j|, sum_i |dS_ij| |q_i|, sum_i P_ij |dO_i|)`` in
    float32, the last two summed over each KV head's query heads: what a
    backward that rounds P and dS to bf16 before the products that read
    them can move its gradients by, per unit roundoff (see
    :func:`grad_bound_excess`).  ``out`` is this module's output; the
    ``(B, Hq, rows, Skv)`` blocks stay under ``_SCORE_ELEMS``."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    lse = attention_lse_ref(q, k, v, causal, window, scale).reshape(b, hkv, g, sq)
    do = d_out.reshape(b, hkv, g, sq, d)
    delta = (do * out.reshape(b, hkv, g, sq, d)).sum(-1)
    t_q = torch.empty((b, hkv, g, sq, d), dtype=q.dtype, device=q.device)
    t_k = torch.zeros((b, hkv, skv, d), dtype=q.dtype, device=q.device)
    t_v = torch.zeros_like(t_k)
    qa, ka = q.abs().reshape(b, hkv, g, sq, d), k.abs()[:, :, None]
    for lo, hi, s, vis in _row_blocks(q, k, scale, causal, window):
        p = torch.exp(s.masked_fill(~vis, -torch.inf) - lse[..., lo:hi, None])
        dor = do[:, :, :, lo:hi]
        t_v += (p.transpose(-1, -2) @ dor.abs()).sum(2)
        ds = (p * (dor @ v[:, :, None].transpose(-1, -2) - delta[..., lo:hi, None])).abs()
        del p
        t_q[:, :, :, lo:hi] = ds @ ka
        t_k += (ds.transpose(-1, -2) @ qa[:, :, :, lo:hi]).sum(2)
    return t_q.reshape(b, hq, sq, d), t_k, t_v


def grad_bound_excess(q, k, v, d_out, grads, causal: bool = True,
                      window: Optional[int] = None,
                      scale: Optional[float] = None,
                      tensor_core: bool = False) -> tuple:
    """Worst ``|got - ref| / allowance`` of each of ``grads = (dq, dk, dv)``
    (``flash_attention``'s backward on these inputs): above 1 is outside.

    ``ref`` is autograd through this module's float32 forward on the same
    values.  The allowance is derived as the forward's: the backward reads
    the kernel's output ``O``, which :func:`bound_excess` holds to
    ``|dO_id| <= u |O_id| + u A(|v|)_id + atol`` (``u`` = :data:`BF16_U`
    for bfloat16 inputs, 0 for float32).  ``D_i = sum_d dO_id O_id`` then
    moves by at most ``E_i = sum_d |dO_id| (u |O_id| + u A(|v|)_id +
    atol)``, ``dS_ij = P_ij (dP_ij - D_i)`` by at most ``P_ij E_i``, so

    * ``dq_i = scale sum_j dS_ij k_j`` by at most ``scale E_i A(|k|)_i``,
    * ``dk_j = scale sum_i dS_ij q_i`` by at most ``scale (P^T (E |q|))_j``,
    * ``dv = P^T dO`` reads no ``D``;

    each plus its cast to the input dtype (``u |ref|``) and ``atol`` =
    :data:`BOUND_ATOL` of float32 arithmetic in another order.  ``A(|x|)``
    is this module's forward with ``|x|`` for the values (the rows' mean of
    ``|x|`` under ``P``); ``P^T X`` is the value gradient for ``d_out = X``.

    ``tensor_core``: the backward kernel (``flash_attention_bwd.cu``) also
    rounds P to bf16 before ``dV = P^T dO`` and dS to bf16 before ``dQ =
    scale dS K`` and ``dK = scale dS^T Q``, the same step that the forward's
    ``u A(|v|)`` term allows for: a rounded entry moves by at most ``u``
    times itself, and the products are exact sums of such entries times
    bf16 inputs (float32 accumulation aside, which ``atol`` covers), so

    * ``dv_j`` moves by at most ``u (P^T |dO|)_j``,
    * ``dq_i`` by at most ``scale u sum_j |dS_ij| |k_j|``,
    * ``dk_j`` by at most ``scale u sum_i |dS_ij| |q_i|``

    (GQA: ``i`` runs over every query head of ``j``'s group), each added to
    the allowance; ``P`` and ``dS`` are this module's in float32.  For
    float32 inputs ``u`` = 0 and the allowance is the same either way.
    """
    b, hq, hkv, sq, skv, d = check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    u = BF16_U if q.dtype == torch.bfloat16 else 0.0
    mask = dict(causal=causal, window=window, scale=scale)
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
        out = flash_attention_ref(qf, kf, vf, **mask)
        gf = d_out.detach().float()
        ref = torch.autograd.grad(out, (qf, kf, vf), gf)
        out = out.detach()
        with torch.no_grad():
            a_v = flash_attention_ref(qf, kf, vf.abs(), **mask)
            a_k = flash_attention_ref(qf, kf, kf.abs(), **mask)
            e = (gf.abs() * (u * out.abs() + u * a_v + BOUND_ATOL)).sum(-1, keepdim=True)
        v2 = vf.detach().requires_grad_()
        pt_eq = torch.autograd.grad(flash_attention_ref(qf.detach(), kf.detach(), v2, **mask),
                                    (v2,), e * qf.detach().abs())[0]
    allow = [u * ref[0].abs() + scale * e * a_k + BOUND_ATOL,
             u * ref[1].abs() + scale * pt_eq + BOUND_ATOL,
             u * ref[2].abs() + BOUND_ATOL]
    if tensor_core and u:
        with torch.no_grad():
            t_q, t_k, t_v = _rounding_terms(qf.detach(), kf.detach(), vf.detach(), gf,
                                            out, causal, window, scale)
        allow[0] += scale * u * t_q
        allow[1] += scale * u * t_k
        allow[2] += u * t_v
    return tuple(float(((g.float() - r).abs() / a).max())
                 for g, r, a in zip(grads, ref, allow))
