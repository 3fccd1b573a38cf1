"""The port's CUDA kernels on the card (skipped where there is none).

Each test is marked ``cuda`` and skips, with a reason, when
``torch.cuda.is_available()`` is false — decided inside the fixture, never
at import.  On a machine with an H100 run them with

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

The kernels are built from ``src/repro_torch/csrc`` at first use.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
from repro_torch.kernels.hash_mix.ref import hash_mix_ref
from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref
from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
from repro_torch.kernels.tanimoto.ref import tanimoto_topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


HASH_WIDTHS = (1, 8, 31, 32, 33, 40, 64, 128, 256, 512)


@pytest.mark.parametrize("w", HASH_WIDTHS)
@pytest.mark.parametrize("n,seed", [(1, 0), (4099, 7), (1000, 2**32 - 1)])
def test_hash_mix_kernel_matches_plain(cuda, n, w, seed):
    """Every width, N off the 128-row tile, both ends of the seed range;
    the route is the one ``route`` names, counted once."""
    from repro_torch.kernels.hash_mix.kernel import route

    rng = np.random.default_rng(n + w)
    x = torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32)).to(cuda)
    path = route(w, x.data_ptr())
    assert path == ("staged" if w in (32, 64, 128, 256) else "rowwise")
    before = hash_mix_cuda.launches
    on_route = getattr(hash_mix_cuda, f"{path}_launches")
    got = hash_mix_cuda(x, seed=seed).cpu().numpy()
    want = hash_mix_ref(x.cpu(), seed=seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert hash_mix_cuda.launches == before + 1
    assert getattr(hash_mix_cuda, f"{path}_launches") == on_route + 1


@pytest.mark.parametrize("w", [32, 64, 128, 256])
def test_hash_mix_both_routes_agree_and_unaligned_slice(cuda, w):
    """The staged kernel against the rowwise one and the plain version at
    N = 70,001 (a ragged last tile, several tiles per block), and a
    contiguous slice 4 bytes off 16-byte alignment, which takes the rowwise
    route; two launches give the same bits."""
    from repro_torch.kernels.hash_mix.kernel import launch, route

    rng = np.random.default_rng(w)
    n = 70_001
    flat = torch.from_numpy(rng.integers(0, 2**32, n * w + 1, dtype=np.uint32)).to(cuda)
    aligned = flat[: n * w].view(n, w)
    shifted = flat[1:].view(n, w)
    assert route(w, aligned.data_ptr()) == "staged"
    assert route(w, shifted.data_ptr()) == "rowwise"
    for x in (aligned, shifted):
        want = hash_mix_ref(x.cpu(), seed=5).numpy()
        for path in ("staged", "rowwise"):
            if path == "staged" and x is shifted:
                continue
            out = torch.empty((n, 4), dtype=torch.uint32, device=cuda)
            launch(path, x, out, 5)
            np.testing.assert_array_equal(out.cpu().numpy(), want)
        first = hash_mix_cuda(x, seed=5)
        second = hash_mix_cuda(x, seed=5)
        assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    # the staged entry point refuses an unaligned base rather than misread it
    out = torch.empty((n, 4), dtype=torch.uint32, device=cuda)
    with pytest.raises(RuntimeError, match="staged kernel launch failed"):
        launch("staged", shifted, out, 0)


def _probe_table(rng, m, bits):
    """``m`` sorted (hi, lo) pairs; ``bits`` < 32 narrows lo and hi so that
    runs of equal keys form."""
    t = rng.integers(0, 2**32, (m, 2), dtype=np.uint32)
    if bits < 32:
        t[:, 0] &= np.uint32(3)
        t[:, 1] &= np.uint32((1 << bits) - 1)
    return np.sort(t.view([("hi", "<u4"), ("lo", "<u4")]).ravel(),
                   order=["hi", "lo"]).view(np.uint32).reshape(-1, 2)


def _probe_queries(rng, t, q):
    """``q`` queries: most from the table, some random, the extremes and
    keys below the minimum and above the maximum."""
    m = t.shape[0]
    fixed = np.array([[0, 0], [0xFFFFFFFF, 0xFFFFFFFF], t[0], t[-1]], np.uint32)
    below = t[0].copy()
    if below[1] > 0:
        below[1] -= 1
    above = t[-1].copy()
    if above[1] < 0xFFFFFFFF:
        above[1] += 1
    body = np.vstack([t[rng.integers(0, m, q)],
                      rng.integers(0, 2**32, (q, 2), dtype=np.uint32)])
    rows = np.vstack([fixed, below, above, body[rng.permutation(2 * q)]])[:q]
    return np.ascontiguousarray(rows[rng.permutation(q)])


@pytest.mark.parametrize("bits", [3, 20, 32])
@pytest.mark.parametrize("m", [1, 7, 2**13 - 1, 2**13 + 1, 100_003, 4_194_304])
def test_sorted_probe_kernel_matches_plain(cuda, m, bits):
    """The kernel against the plain version at Q = 1, 31, 3,500 and
    300,000: duplicate runs, keys below the minimum and above the maximum;
    one launch counted per call."""
    rng = np.random.default_rng(m + bits)
    tt = torch.from_numpy(_probe_table(rng, m, bits)).to(cuda)
    for q in (1, 31, 3_500, 300_000):
        tq = torch.from_numpy(_probe_queries(rng, tt.cpu().numpy(), q)).to(cuda)
        f_r, p_r = sorted_probe_ref(tq, tt)
        before = sorted_probe_cuda.launches
        f, p = sorted_probe_cuda(tq, tt)
        assert torch.equal(f, f_r) and torch.equal(p, p_r), (m, bits, q)
        assert sorted_probe_cuda.launches == before + 1


def test_sorted_probe_is_deterministic(cuda):
    """Two launches give the same bits, at a request's shape and a bulk
    batch's."""
    rng = np.random.default_rng(11)
    tt = torch.from_numpy(_probe_table(rng, 1_000_003, 32)).to(cuda)
    for q in (32, 300_000):
        tq = torch.from_numpy(_probe_queries(rng, tt.cpu().numpy(), q)).to(cuda)
        f1, p1 = sorted_probe_cuda(tq, tt)
        f2, p2 = sorted_probe_cuda(tq, tt)
        assert torch.equal(f1, f2) and torch.equal(p1, p2)


def test_hash_mix_sass_has_its_design_instruction(cuda):
    """The staged hash_mix copies rows with cp.async (LDGSTS) and reads
    them from shared memory (LDS); the rowwise kernel does neither."""
    from repro_torch.kernels import build

    mix = build.sass("hash_mix")
    staged = build.sass_opcode_counts(mix, "hash_mix_staged_kernel", ("LDGSTS", "LDS"))
    assert staged["LDGSTS"] > 0 and staged["LDS"] > 0, staged
    rowwise = build.sass_opcode_counts(mix, "hash_mix_kernel", ("LDGSTS", "LDS"))
    assert rowwise == {"LDGSTS": 0, "LDS": 0}, rowwise


def test_funnel_on_the_card(cuda):
    from repro_torch.launch.funnel import run_funnel

    probes, hashes = sorted_probe_cuda.launches, hash_mix_cuda.launches
    summary = run_funnel(800, device="cuda", workers=1, log=lambda s: None)
    assert summary["device"].startswith("cuda")
    assert sorted_probe_cuda.launches > probes
    assert hash_mix_cuda.launches > hashes


def _tie_plane(rng, n, w, distinct):
    """``n`` rows drawn from ``distinct`` fingerprints (row 0 of the base
    is all zero), so that scores tie across slices, warps and lanes."""
    base = rng.integers(0, 2**32, (distinct, w), dtype=np.uint32)
    base &= rng.integers(0, 2**32, (distinct, w), dtype=np.uint32)
    base[0] = 0
    return base[rng.integers(0, distinct, n)]


@pytest.mark.parametrize("n,w,q,k,distinct", [
    (50_000, 32, 37, 32, 64),       # tie flood
    (10_000, 1, 5, 7, 40),          # W = 1 (the scalar path)
    (100_003, 32, 9, 1, 4096),      # k = 1
    (300_000, 32, 4, 1024, 512),    # k = 1,024 over a tie flood
    (5_000, 2, 3, 1024, 100),       # k > N: pads
    (20_000, 3, 8, 16, 30),         # odd W
    (300_000, 32, 6, 2048, 512),    # k = 2,048: lists in shared memory
    (100_000, 32, 5, 8192, 512),    # k = 8,192: lists in global memory
    (3_000, 32, 4, 8192, 100),      # global lists, k > N: pads
])
def test_tanimoto_kernel_matches_plain(cuda, n, w, q, k, distinct):
    rng = np.random.default_rng(n + w + k)
    db = _tie_plane(rng, n, w, distinct)
    qs = np.vstack([db[rng.integers(0, n, q - q // 3)],
                    np.zeros((q // 3, w), np.uint32)])
    tq, tdb = torch.from_numpy(qs).to(cuda), torch.from_numpy(db).to(cuda)
    before = tanimoto_topk_cuda.launches
    s, i = tanimoto_topk_cuda(tq, tdb, k)
    s_r, i_r = tanimoto_topk_ref(tq.cpu(), tdb.cpu(), k)
    np.testing.assert_array_equal(s.cpu().numpy().view(np.uint32),
                                  s_r.numpy().view(np.uint32))
    np.testing.assert_array_equal(i.cpu().numpy(), i_r.numpy())
    assert tanimoto_topk_cuda.launches == before + 1


def test_tanimoto_kernel_unaligned_plane_and_limits(cuda):
    rng = np.random.default_rng(3)
    db = torch.from_numpy(_tie_plane(rng, 4001, 4, 50)).to(cuda)
    view = db[1:]  # rows 16-byte aligned no more: the kernel's scalar loads
    q = view[:6].clone()
    s, i = tanimoto_topk_cuda(q, view, 9)
    s_r, i_r = tanimoto_topk_ref(q.cpu(), view.cpu(), 9)
    np.testing.assert_array_equal(s.cpu().numpy(), s_r.numpy())
    np.testing.assert_array_equal(i.cpu().numpy(), i_r.numpy())
    # any k the reference answers: k > N pads, only k < 1 is refused
    s, i = tanimoto_topk_cuda(q, view, 5000)
    s_r, i_r = tanimoto_topk_ref(q.cpu(), view.cpu(), 5000)
    np.testing.assert_array_equal(s.cpu().numpy(), s_r.numpy())
    np.testing.assert_array_equal(i.cpu().numpy(), i_r.numpy())
    assert (i[:, 4000:] == -1).all()
    with pytest.raises(ValueError, match="k must be"):
        tanimoto_topk_cuda(q, view, 0)


def test_serve_index_similarity_parity_on_the_card(cuda):
    from repro_torch.launch import serve_index

    before = tanimoto_topk_cuda.launches
    args = serve_index.build_parser().parse_args([
        "--device", "cuda", "--records", "2400", "--files", "3",
        "--shards", "4", "--seconds", "0.3", "--similarity", "--skip-naive",
    ])
    out = serve_index.run(args)
    assert out["parity"] == 64 and out["service"]["errors"] == 0
    assert tanimoto_topk_cuda.launches > before


# (B, Hq, Hkv, Sq, Skv, D, causal, window): the CPU file's FA_CASES, the
# ragged and cross-attention cases, D = 48 and 256, rows that see no key
FA_CARD_CASES = [
    (1, 2, 2, 256, 256, 64, True, None),
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 2, 1, 128, 384, 32, True, None),
    (1, 2, 2, 256, 256, 64, True, 128),
    (1, 4, 4, 256, 256, 128, False, None),
    (1, 8, 1, 128, 128, 64, True, None),
    (1, 4, 2, 100, 177, 32, True, None),
    (2, 2, 1, 17, 17, 48, True, 8),
    (1, 4, 4, 131, 131, 64, True, 50),
    (1, 4, 2, 37, 101, 32, False, None),
    (1, 4, 2, 300, 300, 256, True, 100),
    (1, 2, 1, 256, 128, 32, True, None),
    (2, 8, 2, 1000, 1000, 128, True, None),
    (1, 2, 2, 1500, 1500, 64, False, None),   # whisper's encoder: 11 tiles + 92 keys
    (1, 2, 2, 37, 1500, 64, False, None),     # whisper's cross attention
]


def _fa_inputs(cuda, dt, b, hq, hkv, sq, skv, d, seed=None):
    """q, k, v ~ N(0, 1) in the model's layout: (B, S, H, D) on the card,
    viewed as (B, H, S, D), not contiguous."""
    rng = np.random.default_rng(b + hq + sq + skv + d if seed is None else seed)
    q = torch.from_numpy(rng.standard_normal((b, sq, hq, d), np.float32))
    k = torch.from_numpy(rng.standard_normal((b, skv, hkv, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, skv, hkv, d), np.float32))
    return tuple(t.to(cuda, dt).transpose(1, 2) for t in (q, k, v))


def _fa_check(q, k, v, causal, window, want_route):
    """One launch of the kernel against the plain version on the same
    values in float32.  float32 (CUDA-core route): within 2e-5 (the same
    float32 math summed in another order).  bf16 on the CUDA-core route:
    within the output cast's rounding, 2^-8 |ref| + 1e-4.  bf16 on the
    tensor-core route: the kernel also rounds P to bf16 before P V; each
    p_j then moves by at most 2^-8 p_j, so the output moves by at most
    2^-8 sum_j p_j |v_j| / l = 2^-8 A(|v|), A(|v|) being the plain
    version's output for |v|; the bound is 2^-8 |ref| + 2^-8 A(|v|) + 1e-4
    (``bound_excess``), and a kernel that loses a key tile reads hundreds
    of times above it (tests/test_torch_attention_route.py)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ref import bound_excess, flash_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in fp32
    assert route(q, k, v) == want_route
    before = (flash_attention_cuda.launches, flash_attention_cuda.tc_launches)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal,
                               window=window)
    torch.cuda.synchronize()
    tc = int(want_route == "tensor_core")
    assert (flash_attention_cuda.launches, flash_attention_cuda.tc_launches) == (
        before[0] + 1, before[1] + tc)
    assert got.dtype == q.dtype and got.shape == want.shape
    if q.dtype == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5, rtol=2e-5)
    elif tc:
        abs_v = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                    causal=causal, window=window)
        assert bound_excess(got, want, abs_v) <= 1.0
    else:
        assert bound_excess(got, want) <= 1.0
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", FA_CARD_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, hq, hkv, sq, skv,
                                              d, causal, window):
    dt = getattr(torch, dtype)
    q, k, v = _fa_inputs(cuda, dt, b, hq, hkv, sq, skv, d)
    # every bf16 case is a view TMA reads: the tensor-core route
    _fa_check(q, k, v, causal, window,
              "cuda_core" if dt == torch.float32 else "tensor_core")


@pytest.mark.parametrize("case", ["d20", "seq_stride_136_bytes"])
def test_flash_attention_bf16_cuda_core_route(cuda, case):
    """bf16 inputs that TMA cannot read take the CUDA-core kernel."""
    if case == "d20":
        q, k, v = _fa_inputs(cuda, torch.bfloat16, 1, 4, 2, 150, 150, 20)
    else:  # (B, S, 1, 68) sliced to D = 64: sequence stride 136 bytes
        x = torch.randn((1, 200, 1, 68), device=cuda).to(torch.bfloat16)
        q = k = v = x[..., :64].transpose(1, 2)
    _fa_check(q, k, v, True, None, "cuda_core")


# (B, Hq, Hkv, S, D, window): one or two heads in the serving layout at
# each tensor-core tile shape, prompts that end inside a tile
FA_SERVING_CASES = [
    (1, 2, 1, 1000, 64, None),
    (2, 1, 1, 777, 128, None),
    (1, 2, 2, 2048, 128, None),
    (1, 2, 1, 1500, 256, 1024),
    (1, 1, 1, 600, 256, None),
]


@pytest.mark.parametrize("b,hq,hkv,s,d,window", FA_SERVING_CASES)
def test_flash_attention_tensor_core_serving_layouts(cuda, b, hq, hkv, s, d, window):
    q, k, v = _fa_inputs(cuda, torch.bfloat16, b, hq, hkv, s, s, d)
    _fa_check(q, k, v, True, window, "tensor_core")


def test_flash_attention_tensor_core_is_deterministic(cuda):
    """No split over keys and no atomics: two launches, the same bits."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    q, k, v = _fa_inputs(cuda, torch.bfloat16, 2, 8, 2, 1000, 1000, 128)
    first = flash_attention_cuda(q, k, v, causal=True)
    second = flash_attention_cuda(q, k, v, causal=True)
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


def test_flash_attention_sass_has_tensor_core_and_tma_instructions(cuda):
    """The built tensor-core kernel issues wgmma (HGMMA) and TMA loads
    (UTMALDG); the CUDA-core kernel issues neither."""
    from repro_torch.kernels import build

    text = build.sass("flash_attention")
    tc = build.sass_opcode_counts(text, "fa_forward_tc", ("HGMMA", "UTMALDG"))
    assert tc["HGMMA"] > 0 and tc["UTMALDG"] > 0, tc
    plain = build.sass_opcode_counts(text, "fa_forwardI", ("HGMMA", "UTMALDG"))
    assert plain == {"HGMMA": 0, "UTMALDG": 0}, plain


def test_lm_smoke_prefill_on_the_card_matches_the_cpu(cuda):
    """The smoke yi-6b in float32: card logits (through the kernel) against
    the CPU's (through the plain version) on the same weights."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models.transformer import init_lm, lm_decode_step, lm_prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("yi-6b").smoke(), dtype="float32")
    model = init_lm(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 259, (3, 77)))
    lens = torch.tensor([77, 40, 1])
    before = flash_attention_cuda.launches
    got, cache = lm_prefill(card, cfg, toks.to(cuda), max_len=96, lengths=lens.to(cuda))
    want, cpu_cache = lm_prefill(model, cfg, toks, max_len=96, lengths=lens)
    assert flash_attention_cuda.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    tok = torch.argmax(want, -1)[:, None]
    got, _ = lm_decode_step(card, cfg, tok.to(cuda), lens.to(cuda), cache)
    want, _ = lm_decode_step(model, cfg, tok, lens, cpu_cache)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)


def test_lm_smoke_continuous_serving_on_the_card(cuda):
    """``launch.serve --continuous`` on the card by default: every prompt
    served, the pool's books balanced (the launcher checks and closes)."""
    from repro_torch.launch import serve

    out = serve.run(serve.build_parser().parse_args(
        ["--continuous", "--max-new-tokens", "6", "--max-len", "64",
         "--prompts", "InChI=1S/C12H22O2/", "C", "x" * 50]))
    assert out["device"].startswith("cuda") and out["continuous"]
    assert out["counters"]["completed"] == 3
    assert all(1 <= len(t) <= 6 for t in out["runs"][0]["token_ids"])


def test_lm_smoke_serving_on_the_card(cuda):
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch import serve

    before = flash_attention_cuda.launches
    out = serve.run(serve.build_parser().parse_args(
        ["--device", "cuda", "--max-new-tokens", "6", "--max-len", "64",
         "--repeats", "2", "--prompts", "InChI=1S/C12H22O2/", "C", "x" * 50]))
    assert out["device"].startswith("cuda")
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    assert flash_attention_cuda.launches == before + 2 * out["n_layers"]


# (BH, C, P, N): the CPU file's SSD_CASES, an odd P·N (the one-float path)
# and mamba2-1.3b's served prefill shape
SSD_CARD_CASES = [(2, 4, 8, 16), (6, 16, 64, 128), (1, 1, 4, 4), (3, 32, 16, 32),
                  (5, 7, 3, 5), (512, 8, 64, 128)]


@pytest.mark.parametrize("bh,c,p,n", SSD_CARD_CASES)
def test_ssd_scan_kernel_matches_plain_bit_for_bit(cuda, bh, c, p, n):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    rng = np.random.default_rng(bh * 10 + c)
    states = torch.from_numpy(rng.standard_normal((bh, c, p, n)).astype(np.float32))
    decay = torch.from_numpy(rng.uniform(0.0, 1.0, (bh, c)).astype(np.float32))
    states, decay = states.to(cuda), decay.to(cuda)
    before = ssd_scan_cuda.launches
    got = ssd_scan_cuda(states, decay)
    want = ssd_scan_ref(states, decay)       # the plain version on the card
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == before + 1
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ssd_scan_ref(states.cpu(), decay.cpu()).numpy())


def test_ssd_scan_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    s = torch.zeros((2, 3, 4, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd_scan_cuda(s.half(), torch.ones((2, 3), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_cuda(s.transpose(2, 3), torch.ones((2, 3), device=cuda))
    # an unaligned view takes the one-float path
    flat = torch.randn(1 + 2 * 3 * 4 * 4, device=cuda)
    view = flat[1:].view(2, 3, 4, 4)
    decay = torch.rand((2, 3), device=cuda)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    assert torch.equal(ssd_scan_cuda(view, decay), ssd_scan_ref(view, decay))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_recurrent_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """The f32 smoke configs: card prefill and decode (through the kernels)
    against the CPU's (through the plain versions) on the same weights."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    api = build_model(cfg)
    model = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 259, (3, 77)))
    lens = torch.tensor([77, 40, 2])
    batch = {"tokens": toks, "lengths": lens}
    card_batch = {k: v.to(cuda) for k, v in batch.items()}
    before = (flash_attention_cuda.launches, ssd_scan_cuda.launches)
    got, cache = api.prefill(card, card_batch, max_len=96)
    want, cpu_cache = api.prefill(model, batch, max_len=96)
    n_attn = cfg.n_layers // cfg.hybrid_block if cfg.family == "hybrid" else 0
    assert (flash_attention_cuda.launches - before[0],
            ssd_scan_cuda.launches - before[1]) == (n_attn, cfg.n_layers - n_attn)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for _ in range(3):
        tok = torch.argmax(want, -1)[:, None]
        got, cache = api.decode_step(card, tok.to(cuda), lens.to(cuda), cache)
        want, cpu_cache = api.decode_step(model, tok, lens, cpu_cache)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
        lens = lens + 1


def test_mamba2_smoke_serving_on_the_card(cuda):
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.launch import serve

    before = ssd_scan_cuda.launches
    out = serve.run(serve.build_parser().parse_args(
        ["--arch", "mamba2-1.3b", "--device", "cuda", "--max-new-tokens", "6",
         "--repeats", "2", "--prompts", "InChI=1S/C12H22O2/", "C", "x" * 50]))
    assert out["device"].startswith("cuda")
    assert out["runs"][0]["token_ids"] == out["runs"][1]["token_ids"]
    assert ssd_scan_cuda.launches == before + 2 * out["n_layers"]


# (start, S, Hq, Hkv): suffix prefill's attention, queries the last S of
# start + S keys (``off = start``), start a multiple of the block size (16)
# and not of the tensor-core tile (128) but for 1,024 and 1,536; the last
# three at yi-6b's heads (served: start 1,536 and S 512, or 1,024 and 48)
FA_SUFFIX_CASES = [(16, 32, 4, 2), (48, 64, 4, 2), (48, 160, 4, 2),
                   (1024, 256, 4, 2), (1024, 16, 4, 2), (1536, 512, 32, 4),
                   (1024, 48, 32, 4), (1040, 208, 32, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start,s,hq,hkv", FA_SUFFIX_CASES)
def test_flash_attention_at_suffix_prefill_shapes(cuda, dtype, start, s, hq, hkv):
    """q (1, Hq, S, D) of the model's layout against k, v gathered from a
    block pool (``paged_view``), as ``lm_prefill_suffix`` calls it."""
    from repro_torch.models.common import paged_view

    dt = getattr(torch, dtype)
    d, bs = 128, 16
    n_blocks = (start + s) // bs
    rng = np.random.default_rng(start + s)
    q = torch.from_numpy(rng.standard_normal((1, s, hq, d), np.float32))
    q = q.to(cuda, dt).transpose(1, 2)
    pools = [torch.from_numpy(rng.standard_normal((hkv, (n_blocks + 3) * bs, d),
                                                  np.float32)).to(cuda, dt)
             for _ in range(2)]
    table = torch.from_numpy(rng.permutation(n_blocks + 3)[:n_blocks]).to(cuda)
    k, v = (paged_view(p, table[None], bs) for p in pools)
    assert k.shape == (1, hkv, start + s, d)
    _fa_check(q, k, v, True, None,
              "cuda_core" if dt == torch.float32 else "tensor_core")


def test_digest_ids_card_equals_cpu(cuda):
    from repro_torch.kernels.hash_mix.ops import digest_ids, hash_mix_u64

    ids = [f"InChI=1S/C{i}H{2 * i + 2}/c{i}" for i in range(3000)] + ["", "é" * 90]
    before = hash_mix_cuda.launches
    got = digest_ids(ids, seed=5, device="cuda")
    assert hash_mix_cuda.launches == before + 1
    want = digest_ids(ids, seed=5, device="cpu")
    assert got.dtype == np.uint32 and np.array_equal(got, want)
    x = torch.randint(0, 2**31, (257, 40), dtype=torch.int64).to(torch.uint32)
    assert np.array_equal(hash_mix_u64(x.to(cuda), 3).cpu().numpy(),
                          hash_mix_u64(x, 3).numpy())


def _smoke_lm(cuda, arch="yi-6b", dtype="float32"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    api = build_model(cfg)
    return cfg, api, api.init(torch.Generator(device=cuda).manual_seed(0), cuda)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_on_the_card_equals_dense_decode(cuda, dtype):
    """Row 1 of a 3-row prefill decodes through the dense cache and through
    slot 1 of 3 paged slots (0 and 2 inactive): equal bit for bit."""
    from repro_torch.serve.kvcache import BlockManager, PagedCacheSpec

    cfg, api, model = _smoke_lm(cuda, dtype=dtype)
    bs, max_len, n = 16, 128, 40
    spec = PagedCacheSpec(n_blocks=40, block_size=bs, max_slots=3,
                          max_blocks_per_seq=max_len // bs)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 259, (1, n)))
    toks = toks.repeat(3, 1).to(cuda)
    logits, dense = api.prefill(model, {"tokens": toks,
                                        "lengths": torch.full((3,), n, device=cuda)},
                                max_len=max_len)
    mgr = BlockManager(spec)
    assert mgr.admit(1, n + 10)
    pool = api.paged_cache_init(spec.n_blocks, bs, cuda)
    api.paged_prefill_write(pool, [{k: t[1:2] for k, t in c.items()} for c in dense],
                            torch.from_numpy(mgr.tables[1]).to(cuda), bs)
    cur = torch.argmax(logits, -1)[:, None]
    pos = torch.full((3,), n, device=cuda)
    p_cur = torch.zeros((3, 1), dtype=torch.long, device=cuda)
    p_cur[1] = cur[1]
    p_pos = torch.tensor([0, n, 0], device=cuda)
    tables = torch.from_numpy(mgr.tables).to(cuda)
    for _ in range(8):
        lg, dense = api.decode_step(model, cur, pos, dense)
        p_lg, pool = api.decode_step_paged(model, p_cur, p_pos, tables, pool, bs)
        assert torch.equal(p_lg[1], lg[1])
        cur, pos = torch.argmax(lg, -1)[:, None], pos + 1
        p_cur[1, 0] = torch.argmax(p_lg[1])
        p_pos[1] += 1


def test_suffix_prefill_on_the_card_near_full_prefill(cuda):
    """float32: suffix logits within 1e-4 of full prefill's (the kernel sees
    the rows in other tiles), bf16 within the smoke config's logit spread."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    for dtype, atol in (("float32", 1e-4), ("bfloat16", 5e-2)):
        cfg, api, model = _smoke_lm(cuda, dtype=dtype)
        bs, max_len, n = 16, 128, 70
        prompt = np.random.default_rng(2).integers(0, 259, n)
        toks = np.full((1, 80), 258)
        toks[0, :n] = prompt
        full, dense = api.prefill(model, {"tokens": torch.from_numpy(toks).to(cuda),
                                          "lengths": torch.tensor([n], device=cuda)},
                                  max_len=max_len)
        pool = api.paged_cache_init(12, bs, cuda)
        row = torch.tensor([1, 2, 3, 4, 5, 0, 0, 0], device=cuda)
        api.paged_prefill_write(pool, dense, row, bs)
        for start in (16, 48):
            own = row.clone()
            own[start // bs:5] = torch.arange(6, 6 + 5 - start // bs, device=cuda)
            before = flash_attention_cuda.launches
            got, pool = api.prefill_suffix(
                model, torch.from_numpy(toks[:, start:]).to(cuda), start, own, pool,
                bs, lengths=torch.tensor([n - start], device=cuda))
            assert flash_attention_cuda.launches == before + cfg.n_layers
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       full.float().cpu().numpy(), atol=atol, rtol=atol)


def test_continuous_engine_on_the_card(cuda):
    """float32 smoke yi-6b: continuous greedy tokens == the static engine's,
    prefix sharing on == off, the pool's books balance after close."""
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.kvcache import PagedCacheSpec
    from repro_torch.serve.scheduler import ContinuousEngine

    cfg, _, model = _smoke_lm(cuda)
    stem = "InChI=1S/C8H9NO2/c1-6(10)9-7-2-4-8(11)5-3-7;"
    texts = [stem + t for t in ("a1", "b22", "c333", "a1")] + ["C", "x" * 50]
    spec = PagedCacheSpec(n_blocks=80, block_size=16, max_slots=4, max_blocks_per_seq=8)
    scfg = ServeConfig(max_new_tokens=12, max_len=128)
    static = [r.token_ids for r in Engine(cfg, model, scfg, device=cuda).generate(texts)]
    outs = {}
    for prefix in (True, False):
        eng = ContinuousEngine(cfg, model, spec, scfg, prefix_cache=prefix, device=cuda)
        outs[prefix] = [r.token_ids for r in eng.generate(texts)]
        if prefix:
            assert eng.stats.prefix_hits >= 3
        eng.close(drain=True)
        eng.check()
    assert outs[True] == outs[False] == static


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"])
def test_moe_smoke_on_the_card_matches_the_cpu(cuda, arch):
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.moe import monitor
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    api = build_model(cfg)
    model = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 259, (3, 77)))
    lens = torch.tensor([77, 40, 2])
    with monitor(card) as card_drops:
        got, cache = api.prefill(card, {"tokens": toks.to(cuda),
                                        "lengths": lens.to(cuda)}, max_len=96)
    with monitor(model) as cpu_drops:
        want, cpu_cache = api.prefill(model, {"tokens": toks, "lengths": lens},
                                      max_len=96)
    assert (int(sum(c.dropped for c in card_drops))
            == int(sum(c.dropped for c in cpu_drops)))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for _ in range(3):
        tok = torch.argmax(want, -1)[:, None]
        got, cache = api.decode_step(card, tok.to(cuda), lens.to(cuda), cache)
        want, cpu_cache = api.decode_step(model, tok, lens, cpu_cache)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                                   rtol=1e-4)
        lens = lens + 1


# ---------------------------------------------------------------------------
# training: gradients through the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bh,c,p,n", [(6, 16, 64, 128), (1, 1, 4, 4), (5, 7, 3, 5),
                                      (256, 8, 64, 128)])
def test_ssd_scan_backward_on_the_card(cuda, bh, c, p, n):
    """The output carries a grad_fn; the backward pass launches the kernel
    once more; ``dstates`` equals autograd through the plain version on the
    card bit for bit, ``ddecay`` within 1e-5 of its terms' magnitude."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    g = torch.Generator(device=cuda).manual_seed(bh + c)
    s = torch.randn((bh, c, p, n), generator=g, device=cuda).requires_grad_()
    d = torch.rand((bh, c), generator=g, device=cuda).requires_grad_()
    go = torch.randn((bh, c, p, n), generator=g, device=cuda)
    before = ssd_scan_cuda.launches
    out = ssd_scan(s, d)
    assert out.grad_fn is not None
    ds, dd = torch.autograd.grad(out, (s, d), go)
    assert ssd_scan_cuda.launches == before + 2
    s2, d2 = s.detach().clone().requires_grad_(), d.detach().clone().requires_grad_()
    ref = ssd_scan_ref(s2, d2)
    if c == 1:
        assert torch.all(ds == 0) and torch.all(dd == 0)
        return
    ws, wd = torch.autograd.grad(ref, (s2, d2), go)
    assert torch.equal(ds, ws)
    terms = (ds * out.detach()).abs().sum(dim=(2, 3))
    assert bool(torch.all((dd - wd).abs() <= 1e-5 * terms + 1e-6))


def _check_backward_kernel(q, k, v, go, causal, window):
    """The tensor-core route's backward beyond the bound: the forward's
    bits are the same with and without the log-sum-exp, which agrees with
    ``attention_lse_ref`` (``lse_excess``), and two launches of the
    backward give the same bits."""
    from repro_torch.kernels.flash_attention.backward import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref, lse_excess

    q, k, v = (t.detach() for t in (q, k, v))
    plain = flash_attention_cuda(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    assert torch.equal(plain.view(torch.int16), out.view(torch.int16))
    want = attention_lse_ref(q.float(), k.float(), v.float(), causal, window)
    assert lse_excess(lse, want) <= 1.0
    first = flash_attention_bwd_cuda(q, k, v, out, go, lse, causal, window)
    second = flash_attention_bwd_cuda(q, k, v, out, go, lse, causal, window)
    for a, b in zip(first, second):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,sq,skv,window,causal", [
    (8, 2, 300, 300, None, True),
    (4, 4, 100, 260, None, True),
    (4, 1, 257, 257, 64, True),
    (2, 2, 1500, 1500, None, False),   # whisper's encoder
    (2, 2, 37, 1500, None, False),     # whisper's cross attention
])
def test_flash_attention_backward_on_the_card(cuda, dtype, hq, hkv, sq, skv, window,
                                              causal):
    """The kernel's output carries a grad_fn; dq, dk, dv against autograd
    through the plain version in float32 on the same values, within the
    bound ``grad_bound_excess`` derives.  bf16 (the tensor-core route): the
    backward kernel runs, once, with its three kernels (the allowance adds
    its bf16 roundings of P and dS), and ``_check_backward_kernel`` holds;
    float32: the PyTorch-ops backward, no kernel (1e-4)."""
    from repro_torch.kernels.flash_attention.backward import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    dt = getattr(torch, dtype)
    tc = dt == torch.bfloat16
    q, k, v = _fa_inputs(cuda, dt, 2, hq, hkv, sq, skv, 64)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    go = torch.randn(q.shape, device=cuda).to(dt)
    counters = ("launches", "delta_launches", "dkdv_launches", "dq_launches")
    before = flash_attention_cuda.launches
    bwd = [getattr(flash_attention_bwd_cuda, c) for c in counters]
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert out.grad_fn is not None and flash_attention_cuda.launches == before + 1
    got = torch.autograd.grad(out, (q, k, v), go)
    assert [getattr(flash_attention_bwd_cuda, c) - n for c, n in zip(counters, bwd)] == \
        [int(tc)] * 4
    ratios = grad_bound_excess(q, k, v, go, got, causal, window, tensor_core=tc)
    assert max(ratios) <= 1.0, ratios
    if tc:
        _check_backward_kernel(q, k, v, go, causal, window)


@pytest.mark.parametrize("b,hq,hkv,s,d,window", [
    (1, 8, 2, 1000, 128, None),    # yi-6b's head dim, a ragged last tile
    (1, 4, 4, 640, 128, 200),
    (1, 4, 2, 700, 256, 256),      # gemma3's window at D = 256
    (2, 2, 1, 333, 256, None),
])
def test_flash_attention_backward_kernel_head_dims(cuda, b, hq, hkv, s, d, window):
    """The backward kernel at the training path's other head dims (causal,
    bf16, the model's layout): the tensor-core bound, the log-sum-exp, the
    forward's bits and determinism."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import grad_bound_excess

    q, k, v = (t.detach().requires_grad_()
               for t in _fa_inputs(cuda, torch.bfloat16, b, hq, hkv, s, s, d))
    go = torch.randn(q.shape, device=cuda).to(torch.bfloat16)
    out = flash_attention(q, k, v, causal=True, window=window)
    got = torch.autograd.grad(out, (q, k, v), go)
    ratios = grad_bound_excess(q, k, v, go, got, True, window, tensor_core=True)
    assert max(ratios) <= 1.0, ratios
    _check_backward_kernel(q, k, v, go, True, window)


def test_flash_attention_backward_sass_has_tensor_core_and_tma_instructions(cuda):
    """Both product kernels of the backward issue wgmma (HGMMA) and TMA
    loads (UTMALDG)."""
    from repro_torch.kernels import build

    text = build.sass("flash_attention_bwd")
    for kernel in ("fa_backward_dkdv", "fa_backward_dq"):
        ops = build.sass_opcode_counts(text, kernel, ("HGMMA", "UTMALDG"))
        assert ops["HGMMA"] > 0 and ops["UTMALDG"] > 0, (kernel, ops)


def test_encdec_smoke_on_the_card_matches_the_cpu(cuda):
    """whisper-small's smoke config in float32 on the same weights: prefill
    logits and both caches, a decode step, and the loss and its gradients,
    on the card (three kernel launches a layer pair in prefill) against
    the CPU."""
    import copy
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.models.registry import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("whisper-small").smoke(), dtype="float32")
    api = build_model(cfg)
    model = api.init(torch.Generator(device="cpu").manual_seed(0), "cpu")
    card = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(0)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (2, cfg.enc_frames, cfg.d_model), np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, 259, (2, 40))),
             "lengths": torch.tensor([40, 13])}
    before = flash_attention_cuda.launches
    got, cache = api.prefill(card, {k: t.to(cuda) for k, t in batch.items()}, max_len=64)
    want, cpu_cache = api.prefill(model, batch, max_len=64)
    assert flash_attention_cuda.launches == before + cfg.n_enc_layers + 2 * cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for part in ("self", "cross"):
        np.testing.assert_allclose(cache[part]["v"].cpu().numpy(),
                                   cpu_cache[part]["v"].numpy(), atol=1e-4, rtol=1e-4)
    tok = torch.argmax(want, -1)[:, None]
    got, _ = api.decode_step(card, tok.to(cuda), batch["lengths"].to(cuda), cache)
    want, _ = api.decode_step(model, tok, batch["lengths"], cpu_cache)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4, rtol=1e-4)
    for m in (model, card):
        for p in m.parameters():
            p.requires_grad_(True)
    grads = []
    for m, dev in ((model, "cpu"), (card, cuda)):
        loss, _ = api.loss(m, {k: t.to(dev) for k, t in batch.items()})
        grads.append((loss, torch.autograd.grad(loss, list(m.parameters()))))
    (lc, gc), (lg, gg) = grads
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()), rtol=1e-4)
    for a, b in zip(gc, gg):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-4, rtol=1e-3)
        assert bool((b != 0).any()) == bool((a != 0).any())


def test_train_smoke_on_the_card_matches_the_cpu(cuda):
    """``launch.train`` on the card by default (jamba's smoke config: both
    kernels and the MoE on one path), and the same state's loss and
    gradients on the card against the CPU's in float32."""
    import dataclasses
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import make_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as work:
        out = train.run(train.build_parser().parse_args(
            ["--arch", "jamba-1.5-large-398b", "--steps", "2", "--seq-len", "64",
             "--global-batch", "2", "--corpus-records", "40", "--workdir", work]))
    assert out["final_step"] == 2 and str(out["trainer"].device).startswith("cuda")
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").smoke(), dtype="float32")
    api = build_model(cfg)
    cpu = make_train_state(api, torch.Generator().manual_seed(0), device="cpu")["model"]
    card = make_train_state(api, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)["model"]
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 259, (2, 96)))
    grads = []
    for model, dev in ((cpu, "cpu"), (card, cuda)):
        loss, _ = api.loss(model, {"tokens": toks.to(dev)})
        grads.append((loss, torch.autograd.grad(loss, list(model.parameters()))))
    (lc, gc), (lg, gg) = grads
    np.testing.assert_allclose(float(lg.detach()), float(lc.detach()), rtol=1e-4)
    for a, b in zip(gc, gg):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-4, rtol=1e-3)
        assert bool((b != 0).any()) == bool((a != 0).any())


# ---------------------------------------------------------------------------
# the kernels under a mesh (a 1x1 DeviceMesh over a one-rank NCCL group)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_mesh(cuda):
    from repro_torch.launch.mesh import make_mesh

    yield make_mesh((1, 1), ("data", "model"), device="cuda")
    torch.distributed.destroy_process_group()


def test_attention_under_a_1x1_mesh_equals_the_kernel(cuda_mesh):
    """``models.common.attend`` on DTensors (local_map) launches the kernel
    on the local block: bit for bit the unsharded kernel's output, on the
    tensor-core route."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.logical import use_mesh
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.common import attend

    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((2, s, h, 128), generator=g, device="cuda",
                           dtype=torch.bfloat16).transpose(1, 2)
               for s, h in ((512, 8), (512, 2), (512, 2)))
    want = flash_attention(q, k, v, causal=True)
    rep = [Replicate(), Replicate()]
    before = flash_attention_cuda.tc_launches
    with use_mesh(cuda_mesh):
        got = attend(*(DTensor.from_local(t, cuda_mesh, rep) for t in (q, k, v)),
                     causal=True)
    assert isinstance(got, DTensor)
    assert flash_attention_cuda.tc_launches == before + 1
    assert torch.equal(got.full_tensor(), want)


def test_scan_under_a_1x1_mesh_equals_the_kernel(cuda_mesh):
    """``models.mamba2._ssd_over_blocks`` on DTensors (local_map): the SSD
    core with its ``ssd_scan`` launch on the local block, bit for bit the
    unsharded one."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.dist.logical import use_mesh
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.models.mamba2 import _ssd, _ssd_over_blocks

    g = torch.Generator(device="cuda").manual_seed(4)
    b, c, q, h, p, n = 2, 4, 64, 16, 64, 128
    xs = torch.randn((b, c, q, h, p), generator=g, device="cuda")
    bm, cm = (torch.randn((b, c, q, n), generator=g, device="cuda") for _ in range(2))
    dt = torch.rand((b, c, q, h), generator=g, device="cuda") * 0.1
    da = -dt * torch.rand((h,), generator=g, device="cuda")
    d_skip = torch.ones((h,), device="cuda")
    args = (xs, bm, cm, dt, da, d_skip)
    want = _ssd(*args)
    rep = [Replicate(), Replicate()]
    before = ssd_scan_cuda.launches
    with use_mesh(cuda_mesh):
        got = _ssd_over_blocks(*(DTensor.from_local(t, cuda_mesh, rep) for t in args))
    assert ssd_scan_cuda.launches == before + 1
    for a, w in zip(got, want):
        assert torch.equal(a.full_tensor(), w)


GRAPH_PROMPTS = (["InChI=1S/C12H22O2/", "C", "x" * 50, "InChI=1S/H2O/h1H2"],
                 ["CC(=O)Oc1ccccc1C(=O)O", "N#N", "y" * 37, "InChI=1S/CH4/h1H4"])


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b", "whisper-small"])
def test_decode_graph_tokens_equal_eager_on_the_card(cuda, arch):
    """float32 smoke configs: the captured step replays the eager step's
    tokens; a second ``generate`` at the same key replays the same graph,
    a second batch size captures another."""
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, _, model = _smoke_lm(cuda, arch)
    scfg = ServeConfig(max_new_tokens=12, max_len=96, sync_every=4)
    eager = Engine(cfg, model, scfg, device=cuda, decode="eager")
    graph = Engine(cfg, model, scfg, device=cuda)
    assert graph.decode == "graph"
    steps = 0
    for prompts in (*GRAPH_PROMPTS, GRAPH_PROMPTS[0][:2]):
        got = graph.generate(prompts)
        assert [r.token_ids for r in got] == [r.token_ids for r in eager.generate(prompts)]
        steps += got[0].steps
    assert graph.captures == 2 and graph.replays == steps
    assert graph.capture_s > 0


def test_decode_graph_sampled_tokens_equal_eager_on_the_card(cuda):
    """The sampled step with the engine's generator registered with the
    graph draws what the eager step draws for the same seed."""
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg, _, model = _smoke_lm(cuda)
    scfg = ServeConfig(max_new_tokens=12, max_len=96, greedy=False, seed=3,
                       temperature=0.9)
    eager = Engine(cfg, model, scfg, device=cuda, decode="eager")
    graph = Engine(cfg, model, scfg, device=cuda, decode="graph")
    for prompts in GRAPH_PROMPTS:
        assert ([r.token_ids for r in graph.generate(prompts)]
                == [r.token_ids for r in eager.generate(prompts)])
    assert graph.captures == 1 and graph.replays > 0


def test_continuous_decode_graph_equals_eager_on_the_card(cuda):
    """Greedy continuous serving through the captured lane step: the
    eager paged step's tokens, through evictions and admissions (6 ragged
    requests, 3 lanes)."""
    from repro_torch.serve.kvcache import PagedCacheSpec
    from repro_torch.serve.scheduler import ContinuousEngine
    from repro_torch.serve.engine import ServeConfig

    cfg, _, model = _smoke_lm(cuda)
    spec = PagedCacheSpec(n_blocks=40, block_size=16, max_slots=3, max_blocks_per_seq=6)
    texts = GRAPH_PROMPTS[0] + GRAPH_PROMPTS[1][:2]
    budgets = [3, 12, 5, 8, 2, 9]
    out = {}
    for mode in ("eager", None):
        eng = ContinuousEngine(cfg, model, spec, ServeConfig(max_new_tokens=12,
                               max_len=96), device=cuda, decode=mode)
        futs = [eng.submit(t, n, lead=False) for t, n in zip(texts, budgets)]
        eng._maybe_lead()
        out[mode] = [f.result(timeout=300).token_ids for f in futs]
        if mode is None:
            assert eng.decode == "graph" and eng.captures == 1
            assert eng.replays == eng.stats.steps > 0
        eng.close(drain=True)
        eng.check()
    assert out[None] == out["eager"]
