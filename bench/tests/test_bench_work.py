"""The benchmark's frozen yardstick equals the port's ``kernels/work.py``
on the shapes of the benchmark's cells, and counts what the configs hold."""

import json
from pathlib import Path

import pytest

import work

pw = pytest.importorskip("repro_torch.kernels.work")
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


@pytest.mark.parametrize("shape", [
    (1, 32, 4, 3840, 3840, 128, True, None, 2),     # a chat admission
    (1, 32, 4, 128, 128, 128, True, None, 2),
    (8, 32, 4, 3938, 3938, 128, True, None, 2),     # a docs batch
    (8, 16, 8, 2048, 2048, 256, True, 1024, 2),
])
def test_attention_work_equals_the_ports(shape):
    assert work.attention_work(*shape) == pw.attention_work(*shape)


@pytest.mark.parametrize("shape", [(8 * 64, 16, 64, 128), (512, 8, 64, 128)])
def test_scan_work_equals_the_ports(shape):
    assert work.scan_work(*shape) == pw.scan_work(*shape)


def test_parameter_counts_match_the_port():
    from repro_torch.device import construct_on_meta
    from repro_torch.models.registry import build_model

    import program
    from reference import dense, ssm
    import torch

    for name, ref in (("yi-6b", dense), ("mamba2-1.3b", ssm)):
        c = json.loads((CONFIGS / f"{name}.json").read_text())
        cfg = program.port_config(c, ref)
        with construct_on_meta():
            model = build_model(cfg).init(torch.Generator(), "cpu")
        count = work.family(c["family"]).params(c)
        assert count["total"] == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("q", [50, 90, 95, 99])
def test_percentile_is_numpys_linear_one(q):
    import numpy as np

    import stats

    xs = list(np.random.default_rng(q).lognormal(size=173))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_the_padded_vocabulary_is_the_published_rule():
    from reference import ssm

    c = json.loads((CONFIGS / "mamba2-1.3b.json").read_text())
    assert c["vocab_size"] == 50277 and ssm.vocab(c) == 50288
    assert ssm.embed_spec(c)[0][1] == (50288, c["d_model"])
