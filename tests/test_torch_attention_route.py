"""``flash_attention``'s route choice, tensor maps and bf16 bound, on the CPU.

The CUDA wrapper picks one of two kernels before launch (``route``): the
tensor-core kernel for bf16 views that TMA can read, the CUDA-core kernel
for the rest.  These tests hold that choice and the tensor-map parameters
the wrapper hands to ``cuTensorMapEncodeTiled`` for the serving views of
the repo's models, and the bound that the tensor-core route is held to on
the card (``bound_excess``): a plain version that rounds P to bf16, as the
tensor-core kernel does, must read within the derived bound and outside
the output-cast-only one, and a version that loses a key tile outside
both.  The kernels themselves run only on the card (``test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.kernel import route, tc_tiles, tensor_maps
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF,
    bound_excess,
    flash_attention_ref,
)

SERVING = ["yi-6b", "qwen2-72b", "internvl2-76b", "gemma3-12b", "whisper-small"]
B, S = 2, 48


def _views(arch, dtype=torch.bfloat16, b=B, s=S, skv=None):
    """The serving path's q, k, v: ``(B, S, H, D)`` projections viewed as
    ``(B, H, S, D)`` (``models/transformer.py`` ``lm_prefill``); with
    ``skv``, k and v are ``(B, skv, Hkv, D)`` projections of an encoder's
    output (the cross attention of ``models/encdec.py``)."""
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    skv = s if skv is None else skv
    q = torch.zeros((b, s, h, d), dtype=dtype).transpose(1, 2)
    k = torch.zeros((b, skv, hkv, d), dtype=dtype).transpose(1, 2)
    v = torch.zeros((b, skv, hkv, d), dtype=dtype).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("arch", SERVING)
def test_serving_views_take_the_tensor_core_route(arch):
    q, k, v = _views(arch)
    assert not q.is_contiguous()
    assert route(q, k, v) == "tensor_core"


@pytest.mark.parametrize("sq", [1, 37, 416])
def test_whisper_cross_views_take_the_tensor_core_route(sq):
    """whisper-small's cross attention: the decoder's ``Sq`` rows against
    the encoder's 1,500 frames, k and v ``(B, F, Hkv, D)`` projections of
    its output viewed as ``(B, Hkv, F, D)``; D = 64 (one 128-byte swizzle
    atom) and 1,500 = 11 key tiles of 128 plus 92 keys."""
    cfg = get_config("whisper-small")
    f, h, d = cfg.enc_frames, cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _views("whisper-small", s=sq, skv=f)
    assert not k.is_contiguous() and k.shape == (B, cfg.n_kv_heads, f, d)
    assert route(q, k, v) == "tensor_core"
    assert tc_tiles(d) == (64, 128) and f % 128 == 92
    maps = tensor_maps(q, k, v)
    assert maps["q"]["dims"] == (d, sq, h, B)
    assert maps["k"]["dims"] == maps["v"]["dims"] == (d, f, h, B)
    assert maps["k"]["strides"] == (h * d * 2, d * 2, f * h * d * 2)
    assert maps["k"]["box"] == (64, 128, 1, 1)


@pytest.mark.parametrize("case", ["float32", "d20", "seq_stride_136_bytes",
                                  "odd_stride_of_a_length_one_dim", "offset_base",
                                  "mixed_dtypes"])
def test_other_inputs_take_the_cuda_core_route(case):
    if case == "float32":
        q, k, v = _views("yi-6b", torch.float32)
    elif case == "d20":
        q = torch.zeros((1, 4, 16, 20), dtype=torch.bfloat16)
        k = v = torch.zeros((1, 2, 16, 20), dtype=torch.bfloat16)
    elif case == "seq_stride_136_bytes":  # (B, S, 1, 68) sliced to D = 64
        x = torch.zeros((1, 32, 1, 68), dtype=torch.bfloat16)[..., :64]
        q = k = v = x.transpose(1, 2)
        assert (q.stride(2) * 2) % 16 != 0
    elif case == "odd_stride_of_a_length_one_dim":  # TMA checks every stride
        q = k = v = torch.zeros(40 * 64, dtype=torch.bfloat16).as_strided(
            (1, 1, 40, 64), (3, 3, 64, 1))
    elif case == "offset_base":  # base pointer 2 bytes past an aligned one
        flat = torch.zeros(1 + 2 * 16 * 64, dtype=torch.bfloat16)
        q = flat[1:].view(1, 2, 16, 64)
        k = v = torch.zeros((1, 2, 16, 64), dtype=torch.bfloat16)
        assert q.data_ptr() % 16 == 2
    else:
        q, k, v = _views("yi-6b")
        v = v.float()
    assert route(q, k, v) == "cuda_core"


@pytest.mark.parametrize("arch", SERVING)
def test_tensor_maps_of_the_serving_views(arch):
    q, k, v = _views(arch)
    cfg = get_config(arch)
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dp, bk = tc_tiles(d)
    assert dp == {64: 64, 128: 128, 256: 256}[d]
    assert bk == (64 if d == 256 else 128)
    maps = tensor_maps(q, k, v)
    for name, heads, rows in (("q", h, 128), ("k", hkv, bk), ("v", hkv, bk)):
        m = maps[name]
        assert m["dims"] == (d, S, heads, B)
        # bytes: the next position skips every head, the next head one row
        assert m["strides"] == (heads * d * 2, d * 2, S * heads * d * 2)
        assert m["box"] == (64, rows, 1, 1)
        assert all(st % 16 == 0 for st in m["strides"])


# -- the bound ---------------------------------------------------------------

def _bf16_inputs(seed, b, hq, hkv, s, d):
    """q, k, v ~ N(0, 1) rounded to bf16, held as float32."""
    rng = np.random.default_rng(seed)
    out = []
    for h in (hq, hkv, hkv):
        x = torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(np.float32))
        out.append(x.to(torch.bfloat16).float())
    return out


def _ref_p_bf16(q, k, v, causal=True, window=None):
    """``flash_attention_ref`` with P rounded to bf16 before P·V and the
    denominator summed from the float32 P, as the tensor-core kernel does;
    the output cast to bf16 as the kernel writes it."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    kx = k.repeat_interleave(g, dim=1)
    vx = v.repeat_interleave(g, dim=1)
    sc = (q * d ** -0.5) @ kx.transpose(2, 3)
    i = torch.arange(s)
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= i[None, :] <= i[:, None]
    if window is not None:
        vis &= i[None, :] > i[:, None] - window
    sc = sc.masked_fill(~vis, NEG_INF)
    p = torch.exp(sc - sc.amax(-1, keepdim=True)) * vis
    den = p.sum(-1, keepdim=True)
    o = (p.to(torch.bfloat16).float() @ vx) / torch.where(den > 0, den, 1.0)
    return o.to(torch.bfloat16).float()


# (B, Hq, Hkv, S, D, window): the shapes of the derivation's simulation, cut
BOUND_CASES = [(1, 4, 2, 256, 64, 128), (1, 4, 1, 384, 128, None)]


@pytest.mark.parametrize("b,hq,hkv,s,d,window", BOUND_CASES)
def test_bf16_p_reads_within_the_derived_bound_only(b, hq, hkv, s, d, window):
    q, k, v = _bf16_inputs(s + d, b, hq, hkv, s, d)
    ref = flash_attention_ref(q, k, v, causal=True, window=window)
    abs_v = flash_attention_ref(q, k, v.abs(), causal=True, window=window)
    got = _ref_p_bf16(q, k, v, window=window)
    assert bound_excess(got, ref, abs_v) <= 1.0
    assert bound_excess(got, ref) > 1.0
    # the bf16 output cast alone is within both
    assert bound_excess(ref.to(torch.bfloat16), ref) <= 1.0


@pytest.mark.parametrize("b,hq,hkv,s,d,window", BOUND_CASES)
def test_losing_a_key_tile_reads_outside_both_bounds(b, hq, hkv, s, d, window):
    q, k, v = _bf16_inputs(s + d + 1, b, hq, hkv, s, d)
    drop = 64
    cut = (slice(None), slice(None), slice(drop, None))
    ref = flash_attention_ref(q, k, v, causal=True, window=window)[cut]
    abs_v = flash_attention_ref(q, k, v.abs(), causal=True, window=window)[cut]
    lost = flash_attention_ref(q[cut], k[cut], v[cut], causal=True, window=window)
    assert bound_excess(lost, ref) > 1.0
    assert bound_excess(lost, ref, abs_v) > 1.0


@pytest.mark.parametrize("b,hq,hkv,s,d,window", BOUND_CASES)
def test_plain_output_matches_the_reference(b, hq, hkv, s, d, window):
    q, k, v = _bf16_inputs(s + d + 2, b, hq, hkv, s, d)
    got = flash_attention_ref(q, k, v, causal=True, window=window)
    want = jax_ref(*(jnp.asarray(t.numpy()) for t in (q, k, v)), causal=True,
                   window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
