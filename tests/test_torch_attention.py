"""The port's ``flash_attention`` plain version against the reference's.

Inputs are made from seeds with numpy and handed to both packages: the
port's ``flash_attention_ref`` (what a wrapper runs for a CPU tensor, and
what the CUDA kernel is held to on the card) against the Pallas kernel in
interpret mode, the reference's unblocked ``flash_attention_ref`` and its
chunked online-softmax path.  Tolerances are those of
``tests/test_kernels.py``: ``atol = rtol = 2e-5`` in float32 (the same
float32 math summed in another order), ``atol = 3e-2`` in bfloat16 (both
sides round the float32 result to bfloat16: one bfloat16 step apart at
most).  The CUDA kernel itself runs only on the card: see
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import (
    flash_attention_chunked as jax_chunked,
    flash_attention_ref as jax_ref,
)
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels import work
from repro_torch.kernels.work import visible_pairs

# (B, Hq, Hkv, Sq, Skv, D, causal, window): tests/test_kernels.py FA_CASES
FA_CASES = [
    (1, 2, 2, 256, 256, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 2, 1, 128, 384, 32, True, None),
    (1, 2, 2, 256, 256, 64, True, 128),
    (1, 4, 4, 256, 256, 128, False, None),
    (1, 8, 1, 128, 128, 64, True, None),   # MQA
]
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_ATOL = 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread is fast enough, and the
    test workers beside this one keep their cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _inputs(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return flash_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FA_CASES)
def test_plain_matches_pallas_and_ref_f32(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _inputs(b * 100 + hq, b, hq, hkv, sq, skv, d)
    got = _port(q, k, v, causal=causal, window=window)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pal = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                 block_q=128, block_k=128, interpret=True)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(pal), **F32_TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **F32_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FA_CASES)
def test_plain_matches_pallas_and_ref_bf16(b, hq, hkv, sq, skv, d, causal, window):
    q, k, v = _inputs(b * 100 + hq + 1, b, hq, hkv, sq, skv, d)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    # the same bfloat16 values on both sides
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16)
                  for t in (tq, tk, tv))
    pal = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                 block_q=128, block_k=128, interpret=True)
    ref = jax_ref(jq, jk, jv, causal=causal, window=window)
    assert pal.dtype == ref.dtype == jnp.bfloat16
    for want in (pal, ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(want, dtype=np.float32),
                                   atol=BF16_ATOL)


def test_causality_property():
    """Perturbing future keys must not change past outputs."""
    q, k, v = _inputs(15, 1, 2, 2, 256, 256, 32)
    out1 = _port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, :, 200:], v2[:, :, 200:] = 99.0, -99.0
    out2 = _port(q, k2, v2)
    np.testing.assert_allclose(out1[:, :, :200], out2[:, :, :200], atol=1e-6)


def test_window_equals_full_when_window_ge_seq():
    q, k, v = _inputs(16, 1, 2, 2, 256, 256, 32)
    full = _port(q, k, v)
    for w in (256, 10_000):
        np.testing.assert_allclose(full, _port(q, k, v, window=w), atol=1e-6)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,chunk", [
    (1, 4, 2, 100, 177, 32, True, None, 96),    # no tile divides Sq or Skv
    (2, 2, 1, 17, 17, 48, True, 8, 64),         # a 17-token prompt, window 8
    (1, 4, 4, 131, 131, 64, True, 50, 48),      # window edge inside tiles
    (1, 2, 2, 65, 300, 32, True, None, 128),    # decode-style offset
])
def test_ragged_lengths_match_chunked(b, hq, hkv, sq, skv, d, causal, window,
                                      chunk):
    q, k, v = _inputs(sq * 7 + skv, b, hq, hkv, sq, skv, d)
    got = _port(q, k, v, causal=causal, window=window)
    want = jax_chunked(*map(jnp.asarray, (q, k, v)), causal=causal,
                       window=window, chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d", [
    (1, 4, 2, 37, 101, 32),     # cross attention: Sq != Skv, no mask
    (2, 6, 3, 64, 20, 48),
])
def test_non_causal_cross_attention(b, hq, hkv, sq, skv, d):
    q, k, v = _inputs(sq + skv, b, hq, hkv, sq, skv, d)
    got = _port(q, k, v, causal=False)
    want = jax_ref(*map(jnp.asarray, (q, k, v)), causal=False)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_head_dim_256(causal, window):
    q, k, v = _inputs(256, 1, 4, 2, 64, 64, 256)
    got = _port(q, k, v, causal=causal, window=window)
    want = jax_ref(*map(jnp.asarray, (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **F32_TOL)


def test_row_that_sees_no_key_is_zero_like_pallas():
    """Sq > Skv under a causal mask: the first Sq - Skv rows sit before key
    0 and see nothing; the Pallas kernel gives them 0 (not the mean of V)."""
    q, k, v = _inputs(3, 1, 2, 1, 256, 128, 32)
    got = _port(q, k, v)
    pal = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), block_q=128,
                                 block_k=128, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), **F32_TOL)
    assert np.all(got[:, :, :128] == 0.0)
    assert np.all(np.abs(got[:, :, 128:]).sum(axis=-1) > 0)


def test_strided_views_equal_contiguous():
    """The model hands (B, S, H, D) tensors transposed to (B, H, S, D)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 40, 4, 32)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 40, 2, 32)).astype(np.float32))
    q, k = x.transpose(1, 2), y.transpose(1, 2)
    assert not q.is_contiguous()
    got = flash_attention(q, k, k, window=9)
    want = flash_attention(q.contiguous(), k.contiguous(), k.contiguous(), window=9)
    assert torch.equal(got, want)


def test_entry_point_dispatch_and_checks():
    q = torch.zeros((1, 4, 8, 32))
    kv = torch.zeros((1, 2, 8, 32))
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, kv, kv)
    with pytest.raises(ValueError, match="unsupported devices"):
        flash_attention(q, kv.to("meta"), kv.to("meta"))        # mixed devices
    # meta tensors (the dry-run): an empty output, the kernel's work counted
    with work.counting() as counts:
        out = flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    assert counts == {"flash_attention": {
        "calls": 1, "flops": 4 * 4 * 32 * visible_pairs(8, 8, True, None),
        "bytes": 4 * 32 * (2 * 4 * 8 + 2 * 2 * 8)}}
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(torch.zeros((1, 3, 8, 32)), kv, kv)
    assert flash_attention_cuda.launches == before
    assert flash_attention(q, kv, kv).shape == (1, 4, 8, 32)
