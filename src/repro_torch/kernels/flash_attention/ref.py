"""Plain PyTorch version of the ``flash_attention`` kernel.

Forward attention with causal and/or sliding-window masks and grouped KV
heads, at the layout of the reference package's kernel: ``q (B, Hq, Sq,
D)`` against ``k, v (B, Hkv, Skv, D)`` → ``(B, Hq, Sq, D)`` in q's dtype.

* Queries are the last ``Sq`` positions of the key stream: row ``i`` sits
  at position ``i + Skv - Sq`` (prefill has ``Sq == Skv``).
* ``causal``: key ``j`` is visible to a query at position ``p`` when
  ``j <= p``; ``window``: when ``j > p - window``.
* Query head ``h`` reads KV head ``h // (Hq // Hkv)``.
* Arithmetic is float32: ``s = (q * scale) . k`` with the masked entries
  set to ``-1e30``, ``p = exp(s - max s) * visible``, ``out = p v / sum p``.
* A row that sees no key outputs 0, as the Pallas kernel does (its
  ``safe_l``) and the reference's default chunked path does.  The
  reference's unblocked ``flash_attention_ref`` gives such a row the mean
  of V instead; the two agree wherever every row sees a key.

Queries are taken in row blocks so that the ``(B, Hq, rows, Skv)`` score
block stays under ``_SCORE_ELEMS`` elements.  Runs on any device; the CPU
tests and the CPU model path use it, and on the card it is the yardstick
that the CUDA kernel is held to, through :func:`bound_excess`.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["BF16_U", "BOUND_ATOL", "NEG_INF", "bound_excess", "check_shapes",
           "flash_attention_ref"]

NEG_INF = -1e30
BF16_U = 2.0 ** -8   # bfloat16's unit roundoff (8 significant bits)
BOUND_ATOL = 1e-4    # float32 arithmetic (the f32 card tests agree in 2e-5)
_SCORE_ELEMS = 1 << 28  # float32 scores per row block (1 GiB)


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
    dev = q.device
    kf = k.float()
    vf = v.float()
    k_pos = torch.arange(skv, device=dev)
    out = torch.empty((b, hq, sq, d), dtype=torch.float32, device=dev)
    rows = max(1, _SCORE_ELEMS // max(1, b * hq * skv))
    for lo in range(0, sq, rows):
        hi = min(sq, lo + rows)
        n = hi - lo
        qf = q[:, :, lo:hi].float() * scale                    # (B, Hq, n, D)
        s = torch.matmul(qf.reshape(b, hkv, g * n, d), kf.transpose(2, 3))
        s = s.reshape(b, hkv, g, n, skv)
        q_pos = torch.arange(lo, hi, device=dev)[:, None] + (skv - sq)
        vis = torch.ones((n, skv), dtype=torch.bool, device=dev)
        if causal:
            vis &= k_pos[None, :] <= q_pos
        if window is not None:
            vis &= k_pos[None, :] > q_pos - window
        s = s.masked_fill(~vis, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * vis
        den = p.sum(dim=-1, keepdim=True)
        o = torch.matmul(p.reshape(b, hkv, g * n, skv), vf)
        o = o.reshape(b, hkv, g, n, d) / torch.where(den > 0, den, 1.0)
        out[:, :, lo:hi] = o.reshape(b, hq, n, d)
    return out.to(q.dtype)


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
