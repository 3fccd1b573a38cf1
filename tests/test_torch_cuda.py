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
