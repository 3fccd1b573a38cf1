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
from repro_torch.kernels.tanimoto.kernel import MAX_K, tanimoto_topk_cuda
from repro_torch.kernels.tanimoto.ref import tanimoto_topk_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,w,seed", [(1, 8, 0), (4099, 40, 7), (1000, 128, 2**32 - 1)])
def test_hash_mix_kernel_matches_plain(cuda, n, w, seed):
    rng = np.random.default_rng(n + w)
    x = torch.from_numpy(rng.integers(0, 2**32, (n, w), dtype=np.uint32)).to(cuda)
    before = hash_mix_cuda.launches
    got = hash_mix_cuda(x, seed=seed).cpu().numpy()
    want = hash_mix_ref(x.cpu(), seed=seed).numpy()
    np.testing.assert_array_equal(got, want)
    assert hash_mix_cuda.launches == before + 1


@pytest.mark.parametrize("m,bits", [(1, 20), (7, 3), (100_003, 20), (100_003, 32)])
def test_sorted_probe_kernel_matches_plain(cuda, m, bits):
    rng = np.random.default_rng(m + bits)
    t = rng.integers(0, 2**32, (m, 2), dtype=np.uint32)
    t[:, 1] &= np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    t = np.sort(t.view([("hi", "<u4"), ("lo", "<u4")]).ravel(),
                order=["hi", "lo"]).view(np.uint32).reshape(-1, 2)
    q = np.vstack([t[rng.integers(0, m, 3000)],
                   rng.integers(0, 2**32, (500, 2), dtype=np.uint32)])
    tq, tt = torch.from_numpy(q).to(cuda), torch.from_numpy(t).to(cuda)
    f, p = sorted_probe_cuda(tq, tt)
    f_r, p_r = sorted_probe_ref(tq.cpu(), tt.cpu())
    np.testing.assert_array_equal(f.cpu().numpy(), f_r.numpy())
    np.testing.assert_array_equal(p.cpu().numpy(), p_r.numpy())


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
    (300_000, 32, 4, MAX_K, 512),   # k = 1,024 over a tie flood
    (5_000, 2, 3, MAX_K, 100),      # k > N: pads
    (20_000, 3, 8, 16, 30),         # odd W
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
    with pytest.raises(ValueError, match=str(MAX_K)):
        tanimoto_topk_cuda(q, view, MAX_K + 1)


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
