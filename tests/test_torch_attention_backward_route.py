"""``flash_attention``'s backward route and the log-sum-exp's plain version,
on the CPU.

The backward follows the forward's route (``backward.backward_route``):
inputs the tensor-core forward takes get the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``), which reads the forward's row
log-sum-exp; every other input gets the float32 PyTorch ops of
``grad.flash_attention_bwd``.  These tests hold that choice, made from
dtypes, shapes and strides alone, for the repo's models' views; which
``d_out`` the kernel reads in place; that the CPU never reaches the kernel
wrapper; and ``attention_lse_ref`` against ``torch.logsumexp`` over the
masked scores and against the ops backward's own first pass.  The kernels
run only on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.backward import backward_route
from repro_torch.kernels.flash_attention.kernel import route, tma_readable
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_lse_ref

# the module, not the package attribute that ``kernels/__init__`` binds to the op
grad = importlib.import_module("repro_torch.kernels.flash_attention.grad")
SERVING = ["yi-6b", "qwen2-72b", "internvl2-76b", "gemma3-12b", "whisper-small"]


def _views(arch, dtype=torch.bfloat16, b=2, s=48):
    """The training path's q, k, v: ``(B, S, H, D)`` projections viewed as
    ``(B, H, S, D)``."""
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return (torch.zeros((b, s, n, d), dtype=dtype).transpose(1, 2) for n in (h, hkv, hkv))


@pytest.mark.parametrize("arch", SERVING)
def test_model_views_take_the_kernel_backward(arch):
    q, k, v = _views(arch)
    assert route(q, k, v) == "tensor_core"
    assert backward_route(q, k, v) == "tensor_core"


@pytest.mark.parametrize("case", ["float32", "float64", "d20", "seq_stride_136_bytes",
                                  "offset_base", "mixed_dtypes"])
def test_other_inputs_take_the_ops_backward(case):
    """Whatever the forward sends to the CUDA-core kernel gets the ops
    backward: the route is the forward's, decided from the inputs alone."""
    if case in ("float32", "float64"):
        q, k, v = _views("yi-6b", getattr(torch, case))
    elif case == "d20":
        q = torch.zeros((1, 4, 16, 20), dtype=torch.bfloat16)
        k = v = torch.zeros((1, 2, 16, 20), dtype=torch.bfloat16)
    elif case == "seq_stride_136_bytes":  # (B, S, 1, 68) sliced to D = 64
        q = k = v = torch.zeros((1, 32, 1, 68), dtype=torch.bfloat16)[..., :64].transpose(1, 2)
    elif case == "offset_base":
        q = torch.zeros(1 + 2 * 16 * 64, dtype=torch.bfloat16)[1:].view(1, 2, 16, 64)
        k = v = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
    else:
        q, k, v = _views("yi-6b")
        v = v.float()
    assert route(q, k, v) == "cuda_core"
    assert backward_route(q, k, v) == "ops"


def test_the_models_output_gradient_is_read_in_place():
    """Autograd hands the attention's output gradient as the transposed
    view of the ``(B, S, H·D)`` projection's gradient: TMA reads it, so the
    kernel takes it without a copy; a gradient with a 136-byte row stride
    is copied first."""
    b, s, h, d = 2, 48, 32, 128
    g = torch.zeros((b, s, h * d), dtype=torch.bfloat16)
    d_out = g.view(b, s, h, d).transpose(1, 2)
    assert not d_out.is_contiguous() and tma_readable(d_out)
    odd = torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)[..., :d].transpose(1, 2)
    assert not tma_readable(odd)
    assert not tma_readable(d_out.float())


@pytest.mark.parametrize("training", [False, True])
def test_the_cpu_never_reaches_the_kernel(monkeypatch, training):
    """On the CPU both directions are the plain versions, whatever the
    forward is told about training: the kernel wrapper is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the CUDA backward")

    monkeypatch.setattr(grad, "flash_attention_bwd_cuda", refuse)
    q, k, v = (torch.randn(shape, dtype=torch.bfloat16).requires_grad_()
               for shape in ((1, 4, 20, 16), (1, 2, 20, 16), (1, 2, 20, 16)))
    out = grad.FlashAttention.apply(q, k, v, True, None, None, training)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    want = grad.flash_attention_bwd(q.detach(), k.detach(), v.detach(), out.detach(),
                                    torch.ones_like(out), True)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)


def test_training_follows_grad_mode_and_requires_grad(monkeypatch):
    """``flash_attention`` tells the forward that a gradient will be taken
    only under grad mode with an input that requires one: serving (no_grad)
    never asks the forward kernel for the log-sum-exp."""
    seen = []
    real = grad.FlashAttention.apply

    def spy(*args):
        seen.append(args[-1])
        return real(*args)

    monkeypatch.setattr(grad.FlashAttention, "apply", spy)
    q, k, v = (torch.randn((1, 2, 8, 16)) for _ in range(3))
    flash_attention(q, k, v)
    with torch.no_grad():
        flash_attention(q.requires_grad_(), k, v)
    flash_attention(q, k, v)
    assert seen == [False, False, True]


# -- the log-sum-exp -----------------------------------------------------------

# (B, Hq, Hkv, Sq, Skv, D, causal, window)
LSE_CASES = [
    (2, 4, 2, 33, 33, 16, True, None),     # causal GQA
    (1, 4, 1, 17, 17, 8, True, None),      # MQA
    (2, 2, 2, 40, 40, 8, True, 7),         # sliding window
    (1, 4, 2, 9, 30, 16, True, None),      # Sq < Skv
    (1, 2, 1, 12, 5, 8, True, None),       # Sq > Skv: rows 0..6 see no key
    (1, 2, 2, 10, 14, 8, False, 4),        # window without the causal mask
    (1, 2, 2, 12, 5, 8, False, None),      # no mask, Sq > Skv
    (1, 2, 2, 6, 9, 8, True, -2),          # a window that hides every key
]
LSE_IDS = ["causal-gqa", "mqa", "window", "sq<skv", "no-key-rows", "window-noncausal",
           "cross-sq>skv", "empty-window"]


def _lse_inputs(case, seed, dtype=np.float64):
    b, hq, hkv, sq, skv, d, *_ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(dtype))
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


def _worst(x):
    return float(x.abs().max()) if x.numel() else 0.0


def _masked_scores(q, k, causal, window):
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    s = (q * d ** -0.5) @ k.repeat_interleave(hq // hkv, 1).transpose(-1, -2)
    pos = torch.arange(sq)[:, None] + skv - sq
    key = torch.arange(skv)[None, :]
    vis = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        vis &= key <= pos
    if window is not None:
        vis &= key > pos - window
    return s.masked_fill(~vis, -torch.inf), vis.any(-1)


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_lse_matches_logsumexp_over_the_masked_scores(case):
    """float64, within 1e-12; +inf exactly on the rows that see no key."""
    *_, causal, window = case
    q, k, v = _lse_inputs(case, 3)
    got = attention_lse_ref(q, k, v, causal, window)
    s, sees = _masked_scores(q, k, causal, window)
    want = torch.logsumexp(s, -1)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert torch.all(torch.isinf(got[..., ~sees]) & (got[..., ~sees] > 0))
    assert _worst(got[..., sees] - want[..., sees]) <= 1e-12


@pytest.mark.parametrize("case", LSE_CASES, ids=LSE_IDS)
def test_lse_matches_the_ops_backwards_first_pass(case, monkeypatch):
    """``grad.row_lse`` (the ops backward's running max and sum over key
    chunks, here chunks of 16) in float32 on the rows that see a key, within
    2e-6; it gives 0 where the kernel's contract gives +inf."""
    monkeypatch.setattr(grad, "_SCORE_ELEMS", 64)
    *_, causal, window = case
    q, k, v = _lse_inputs(case, 4, np.float32)
    got = attention_lse_ref(q, k, v, causal, window)
    first = grad.row_lse(q, k, causal, window)
    sees = torch.isfinite(got)
    assert torch.all(first[~sees] == 0)
    assert _worst(got[sees] - first[sees]) <= 2e-6


def test_lse_is_the_log_of_the_reference_softmax_denominator():
    """exp(s - lse) sums to 1 over the visible keys of every row that sees
    one, and the resulting attention equals the reference package's."""
    case = LSE_CASES[2]
    *_, causal, window = case
    q, k, v = _lse_inputs(case, 5, np.float32)
    lse = attention_lse_ref(q, k, v, causal, window)
    s, sees = _masked_scores(q, k, causal, window)
    p = torch.exp(s - lse[..., None])
    assert float((p.sum(-1) - 1).abs().max()) <= 1e-5
    out = p @ v.repeat_interleave(q.shape[1] // v.shape[1], 1)
    want = jax_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=causal,
                   window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
