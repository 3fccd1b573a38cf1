"""Gradients through the port's two training kernels, on the CPU.

``ssd_scan`` and ``flash_attention`` carry ``torch.autograd.Function``s
(``kernels/ssd_scan/ops.py``, ``kernels/flash_attention/grad.py``).  On a
CPU tensor their forward is the plain version and their backward the
port's own formula (the adjoint scan; the chunked attention backward), so
these tests hold the formulas themselves:

* ``ssd_scan``: the state gradient equals autograd through
  ``ssd_scan_ref`` bit for bit (the adjoint scan multiplies, then adds,
  in the order autograd does), the decay gradient within 1e-6 relative
  (a sum over P x N in another order), and both within 1e-5 of
  ``jax.grad`` of the reference's ``ssd_scan`` (the decay gradient, a sum
  of P x N products, within 1e-5 of the sum of their magnitudes);
* ``flash_attention``: within 1e-10 of autograd through
  ``flash_attention_ref`` in float64, and within 1e-5 of ``jax.grad`` of
  the reference's ``flash_attention`` (its chunked XLA path) in float32,
  over causal GQA, MQA, a window, ``Sq < Skv`` and rows that see no key;
* ``torch.autograd.gradcheck`` on small float64 cases of both.

Inputs come from numpy seeds and go to both packages.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash_attention
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro_torch.kernels.flash_attention.grad import FlashAttention, row_span
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

# (BH, C, P, N), the scan cases of tests/test_kernels.py
SSD_CASES = [(2, 4, 8, 16), (6, 16, 64, 128), (1, 1, 4, 4), (3, 32, 16, 32)]
# (B, Hq, Hkv, Sq, Skv, D, causal, window)
FA_CASES = [
    (2, 4, 2, 33, 33, 16, True, None),     # causal GQA
    (1, 4, 1, 17, 17, 8, True, None),      # MQA
    (2, 2, 2, 40, 40, 8, True, 7),         # sliding window
    (1, 4, 2, 9, 30, 16, True, None),      # Sq < Skv (suffix queries)
    (1, 2, 1, 12, 5, 8, True, None),       # Sq > Skv: rows 0..6 see no key
    (1, 2, 2, 10, 14, 8, False, 4),        # window without the causal mask
    (1, 4, 2, 9, 30, 16, False, None),     # cross attention: Sq < Skv, no mask
    (1, 2, 2, 12, 5, 8, False, None),      # cross attention: Sq > Skv, no mask
]
FA_IDS = ["causal-gqa", "mqa", "window", "sq<skv", "no-key-rows", "window-noncausal",
          "cross-sq<skv", "cross-sq>skv"]


def _seeded(seed, *shapes, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in shapes]


def _leaves(*arrays, grad=True):
    return [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,c,p,n", SSD_CASES)
def test_ssd_scan_grad_equals_autograd_of_plain_version(bh, c, p, n):
    """``dstates`` bit for bit, ``ddecay`` within 1e-6 of its scale."""
    rng = np.random.default_rng(bh * 1000 + c)
    s_np = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    d_np = rng.uniform(0.0, 1.0, (bh, c)).astype(np.float32)
    g_np = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    s, d = _leaves(s_np, d_np)
    got = torch.autograd.grad(ssd_scan(s, d), (s, d), torch.from_numpy(g_np))
    s2, d2 = _leaves(s_np, d_np)
    prefix = ssd_scan_ref(s2, d2)
    if c == 1:  # prefix = h[0] = 0 whatever the inputs: no graph, zero gradients
        assert prefix.grad_fn is None
        want = (torch.zeros_like(s2), torch.zeros_like(d2))
    else:
        want = torch.autograd.grad(prefix, (s2, d2), torch.from_numpy(g_np))
    assert torch.equal(got[0], want[0])
    assert torch.all(got[0][:, -1] == 0)  # h[C] is no output
    scale = float(want[1].abs().max()) + 1e-30
    assert float((got[1] - want[1]).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("bh,c,p,n", SSD_CASES)
def test_ssd_scan_grad_matches_jax_grad(bh, c, p, n):
    rng = np.random.default_rng(bh + 7 * c)
    s_np = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    d_np = rng.uniform(0.0, 1.0, (bh, c)).astype(np.float32)
    g_np = rng.standard_normal((bh, c, p, n)).astype(np.float32)
    want = jax.grad(lambda s, d: jnp.sum(jax_ssd_scan(s, d) * g_np), argnums=(0, 1))(
        jnp.asarray(s_np), jnp.asarray(d_np))
    s, d = _leaves(s_np, d_np)
    prefix = ssd_scan(s, d)
    got = torch.autograd.grad(prefix, (s, d), torch.from_numpy(g_np))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    # ddecay sums P x N products in another order: 1e-5 of the terms' scale
    terms = (got[0] * prefix.detach()).abs().sum(dim=(2, 3)).numpy()
    assert np.all(np.abs(got[1].numpy() - np.asarray(want[1])) <= 1e-5 * terms + 1e-6)


def test_ssd_scan_backward_runs_the_scan_once_more(monkeypatch):
    """Forward and backward are one scan each (the kernel on the card)."""
    ops = importlib.import_module("repro_torch.kernels.ssd_scan.ops")
    calls = []
    real = ops._scan
    monkeypatch.setattr(ops, "_scan", lambda s, d: calls.append(s.shape) or real(s, d))
    s, d = _leaves(*_seeded(0, (2, 5, 3, 4)), np.random.default_rng(1).uniform(
        0, 1, (2, 5)))
    out = ssd_scan(s, d)
    assert out.grad_fn is not None and len(calls) == 1
    out.sum().backward()
    assert len(calls) == 2 and s.grad is not None and d.grad is not None


def test_ssd_scan_gradcheck():
    s, = _leaves(*_seeded(3, (2, 6, 3, 2)))
    d = torch.from_numpy(np.random.default_rng(4).uniform(0.1, 0.9, (2, 6))).requires_grad_()
    assert torch.autograd.gradcheck(ssd_scan, (s, d))


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

def _fa_inputs(case, seed, dtype):
    b, hq, hkv, sq, skv, d, causal, window = case
    return _seeded(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                   (b, hq, sq, d), dtype=dtype)


@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
@pytest.mark.parametrize("score_elems", [1 << 26, 64])
def test_flash_attention_grad_equals_autograd_of_plain_version_f64(case, score_elems,
                                                                   monkeypatch):
    """Float64, within 1e-10; ``score_elems = 64`` forces a key chunk of
    16, so the chunk loop, the row spans and the running log-sum-exp are
    exercised too."""
    grad = importlib.import_module("repro_torch.kernels.flash_attention.grad")
    monkeypatch.setattr(grad, "_SCORE_ELEMS", score_elems)
    *_, causal, window = case
    q_np, k_np, v_np, g_np = _fa_inputs(case, 11, np.float64)
    q, k, v = _leaves(q_np, k_np, v_np)
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(g_np))
    q2, k2, v2 = _leaves(q_np, k_np, v_np)
    want = torch.autograd.grad(
        flash_attention_ref(q2, k2, v2, causal=causal, window=window),
        (q2, k2, v2), torch.from_numpy(g_np))
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= 1e-10


@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_flash_attention_grad_matches_jax_grad_f32(case):
    *_, causal, window = case
    q_np, k_np, v_np, g_np = _fa_inputs(case, 5, np.float32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(q, k, v, causal=causal,
                                                    window=window) * g_np),
        argnums=(0, 1, 2))(jnp.asarray(q_np), jnp.asarray(k_np), jnp.asarray(v_np))
    q, k, v = _leaves(q_np, k_np, v_np)
    got = torch.autograd.grad(flash_attention(q, k, v, causal=causal, window=window),
                              (q, k, v), torch.from_numpy(g_np))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_flash_attention_rows_without_keys_get_zero_gradient():
    case = FA_CASES[4]
    q_np, k_np, v_np, g_np = _fa_inputs(case, 2, np.float64)
    q, k, v = _leaves(q_np, k_np, v_np)
    out = flash_attention(q, k, v, causal=True)
    dq, = torch.autograd.grad(out, (q,), torch.from_numpy(g_np))
    blind = case[3] - case[4]  # rows at positions < 0
    assert torch.all(out[:, :, :blind] == 0) and torch.all(dq[:, :, :blind] == 0)
    assert torch.all(dq[:, :, blind:].abs().sum(-1) > 0)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3), (False, 2)])
def test_flash_attention_gradcheck(causal, window):
    q, k, v = _leaves(*_seeded(9, (1, 4, 5, 4), (1, 2, 7, 4), (1, 2, 7, 4)))
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashAttention.apply(q, k, v, causal, window, None), (q, k, v))


@pytest.mark.parametrize("lo,hi,sq,off,causal,window,want", [
    (0, 16, 32, 0, True, None, (0, 32)),
    (16, 32, 32, 0, True, None, (16, 32)),
    (16, 32, 8, 24, True, None, (0, 8)),     # suffix queries see the whole chunk
    (0, 8, 32, 0, True, 4, (0, 11)),         # window: rows up to 7 + 4 - 1
    (0, 8, 10, -4, True, None, (4, 10)),     # Sq > Skv: rows 0..3 see no key
    (0, 8, 10, 0, False, None, (0, 10)),
    (0, 8, 12, -4, False, None, (0, 12)),    # no mask, Sq > Skv: every row
    (0, 4, 12, -4, False, 2, (0, 9)),        # window only, Sq > Skv
])
def test_row_span(lo, hi, sq, off, causal, window, want):
    """The rows that see some key of a chunk, against a brute-force mask."""
    assert row_span(lo, hi, sq, off, causal, window) == want
    rows = [i for i in range(sq) if any(
        (not causal or j <= i + off) and (window is None or j > i + off - window)
        for j in range(lo, hi))]
    assert (rows[0], rows[-1] + 1) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FA_CASES[:4], ids=FA_IDS[:4])
def test_grad_bound_holds_and_sees_a_lost_delta_term(case, dtype):
    """``grad_bound_excess`` (the card's check): the port's gradients lie
    inside it, in float32 and with bfloat16 inputs and output (whose
    rounding it allows for); a backward that drops the ``D = rowsum(dO *
    O)`` term, a classic slip, lies outside it."""
    from repro_torch.kernels.flash_attention.grad import flash_attention_bwd
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    *_, causal, window = case
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in _fa_inputs(case, 21, np.float32))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, causal=causal, window=window)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert max(grad_bound_excess(q, k, v, g, got, causal, window)) <= 1.0
    wrong = flash_attention_bwd(q.detach(), k.detach(), v.detach(), torch.zeros_like(out),
                                g, causal, window)
    assert max(grad_bound_excess(q, k, v, g, wrong, causal, window)) > 1.0


# -- the tensor-core backward's bound ------------------------------------------

def _kernel_emulation(q, k, v, out, g, causal, window, drop_tile=False, with_delta=True):
    """The backward kernel's roundings on the CPU: float32 arithmetic on the
    bf16 inputs and the bf16 forward output, ``P = exp(S - lse)`` from the
    row log-sum-exp, P rounded to bf16 before ``dV = P^T dO``, dS rounded
    to bf16 before ``dQ = scale dS K`` and ``dK = scale dS^T Q``, outputs
    cast to bf16.  ``drop_tile``: the first 64 keys never visited (their
    P is 0); ``with_delta=False``: ``D = rowsum(dO * O)`` lost."""
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    qf, kf, vf, gf, of = (t.detach().float() for t in (q, k, v, g, out))
    b, hq, sq, d = qf.shape
    hkv, skv = kf.shape[1], kf.shape[2]
    grp = hq // hkv
    scale = d ** -0.5
    kx, vx = kf.repeat_interleave(grp, 1), vf.repeat_interleave(grp, 1)
    pos = torch.arange(sq)[:, None] + skv - sq
    key = torch.arange(skv)[None, :]
    vis = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        vis &= key <= pos
    if window is not None:
        vis &= key > pos - window
    lse = attention_lse_ref(qf, kf, vf, causal, window)[..., None]
    p = torch.exp((qf @ kx.transpose(-1, -2) * scale).masked_fill(~vis, -torch.inf) - lse)
    if drop_tile:
        p[..., :64] = 0.0
    delta = (gf * of).sum(-1, keepdim=True) if with_delta else 0.0
    ds = (p * (gf @ vx.transpose(-1, -2) - delta)).to(torch.bfloat16).float()
    dv = p.to(torch.bfloat16).float().transpose(-1, -2) @ gf
    dq = scale * ds @ kx
    dk = scale * ds.transpose(-1, -2) @ qf

    def group_sum(x):
        return x.reshape(b, hkv, grp, skv, d).sum(2)

    return dq.bfloat16(), group_sum(dk).bfloat16(), group_sum(dv).bfloat16()


# the backward kernel's cases: FA_CASES' masks at 64-key tiles (Skv > 64,
# so that a dropped tile is one of several), whisper's unmasked encoder cut
TC_BOUND_CASES = [
    (1, 4, 2, 160, 160, 64, True, None),     # causal GQA
    (1, 4, 1, 130, 130, 32, True, None),     # MQA, ragged tiles
    (1, 2, 2, 200, 200, 64, True, 50),       # sliding window
    (1, 4, 2, 70, 200, 64, True, None),      # Sq < Skv (suffix queries)
    (1, 2, 2, 150, 150, 64, False, None),    # whisper's encoder, no mask
]
TC_BOUND_IDS = ["causal-gqa", "mqa", "window", "sq<skv", "no-mask"]


def _bf16_case(case, seed):
    b, hq, hkv, sq, skv, d, causal, window = case
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _seeded(seed, (b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                                   (b, hq, sq, d), dtype=np.float32))
    out = flash_attention_ref(q, k, v, causal=causal, window=window)  # bf16, as the kernel's
    return q, k, v, g, out, causal, window


@pytest.mark.parametrize("case", TC_BOUND_CASES, ids=TC_BOUND_IDS)
def test_tc_bound_holds_for_the_kernels_roundings(case):
    """The tensor-core allowance (``grad_bound_excess(tensor_core=True)``)
    holds for an emulation of the kernel's bf16 roundings of P and dS; the
    f32 route's allowance does not (the rounded P moves dV by far more than
    the output cast)."""
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    q, k, v, g, out, causal, window = _bf16_case(case, 31)
    got = _kernel_emulation(q, k, v, out, g, causal, window)
    assert max(grad_bound_excess(q, k, v, g, got, causal, window, tensor_core=True)) <= 1.0
    assert grad_bound_excess(q, k, v, g, got, causal, window)[2] > 1.0


@pytest.mark.parametrize("case", TC_BOUND_CASES, ids=TC_BOUND_IDS)
def test_tc_bound_sees_a_lost_delta_term_and_a_dropped_key_tile(case):
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    q, k, v, g, out, causal, window = _bf16_case(case, 32)
    for wrong in (dict(with_delta=False), dict(drop_tile=True)):
        got = _kernel_emulation(q, k, v, out, g, causal, window, **wrong)
        ratios = grad_bound_excess(q, k, v, g, got, causal, window, tensor_core=True)
        assert max(ratios) > 1.0, (wrong, ratios)


@pytest.mark.parametrize("case", FA_CASES, ids=FA_IDS)
def test_tc_bound_reduces_to_the_f32_allowance_on_f32_inputs(case):
    """On float32 inputs (u = 0) the tensor-core terms vanish: the same
    ratios, bit for bit, as the f32 route's allowance."""
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    *_, causal, window = case
    q, k, v, g = (torch.from_numpy(a) for a in _fa_inputs(case, 33, np.float32))
    got = tuple(torch.from_numpy(a) for a in _seeded(34, q.shape, k.shape, v.shape,
                                                      dtype=np.float32))
    assert grad_bound_excess(q, k, v, g, got, causal, window, tensor_core=True) == \
        grad_bound_excess(q, k, v, g, got, causal, window)
