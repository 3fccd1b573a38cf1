"""The port's roofline terms and dry-run, on the CPU.

* ``RooflineTerms`` and ``model_flops`` on the reference test's inputs
  (``tests/test_roofline_and_bench.py``) give the reference's numbers with
  the H100's constants in place of the TPU's, and a collective is priced
  by the links of its mesh axis.
* The dry-run's parameter totals (a full config built on ``meta``) equal
  the reference's ``param_stats`` through ``abstract_init`` for every arch.
* One smoke cell (yi-6b's prefill, B = 4, S = 16) on a 4-rank fake mesh
  (2 × 2): every argument lives on ``meta``; its GEMM FLOPs per device are
  a quarter of the count from the shapes (batch over "data", heads, d_ff
  and vocab over "model"); its attention FLOPs are the visible-pairs
  formula at the local shapes (one kv head: the heads stay whole, the
  batch is halved); it moves collective bytes over "model"; ``report``
  renders its row.
* DTensor shards a dim laid over two mesh axes major-first in mesh order,
  as the reference's ``("pod", "data")`` groups mean.
* The launcher runs one production cell (whisper-small x prefill_32k on
  the 256-rank fake mesh) to a record that ``report`` renders.

The fake process group lives in this test process only while a test needs
it (the ``fake_pg`` fixture destroys it).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as r_get_config
from repro.models.registry import build_model as r_build_model
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import construct_on_meta
from repro_torch.kernels.work import visible_pairs
from repro_torch.launch import dryrun, report
from repro_torch.launch.roofline import HW, RooflineTerms, model_flops
from repro_torch.models.registry import build_model
from repro_torch.models.specs import param_specs


@pytest.fixture
def fake_pg():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_roofline_terms_arithmetic():
    t = RooflineTerms(
        flops_per_device=989e12,          # exactly 1 s of compute
        bytes_per_device=3.35e12 * 2,     # 2 s of memory
        collective_bytes=50e9 * 0.5,      # 0.5 s at the cross-node rate
        collective_breakdown={},
        peak_memory_bytes=0,
    )
    assert abs(t.t_compute - 1.0) < 1e-9
    assert abs(t.t_memory - 2.0) < 1e-9
    assert abs(t.t_collective - 0.5) < 1e-9
    assert t.bottleneck == "memory"
    assert t.step_time_lb == t.t_memory
    by_axis = dataclasses.replace(t, collective_by_axis={"model": 450e9, "data": 50e9})
    assert abs(by_axis.t_collective - 2.0) < 1e-9    # 1 s on NVLink + 1 s across nodes
    assert HW.link_bw("pod") == HW.link_bw("data") == 50e9
    assert set(t.as_dict()) == {
        "flops_per_device", "bytes_per_device", "collective_bytes",
        "collective_breakdown", "peak_memory_bytes", "t_compute_s", "t_memory_s",
        "t_collective_s", "bottleneck", "step_time_lb_s"}


def test_model_flops_formulas():
    assert model_flops(1e9, 1000, "train") == 6e12
    assert model_flops(1e9, 1000, "inference") == 2e12


def _reference_param_stats(arch):
    # repro.launch.dryrun sets XLA_FLAGS when imported; keep it out of this
    # process's environment (subprocesses of other tests inherit it)
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import abstract_init, param_stats
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    params, specs = abstract_init(r_build_model(r_get_config(arch)))
    return param_stats(params, specs)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_totals_equal_the_reference(arch):
    with construct_on_meta():
        model = build_model(get_config(arch)).init(torch.Generator(), "cpu")
    assert {p.device.type for p in model.parameters()} == {"meta"}
    assert dryrun.param_stats(model, param_specs(model)) == _reference_param_stats(arch)


def _gemm_flops(cfg, b, s):
    """A prefill's matmul FLOPs from the shapes: the projections, the MLP
    and the last position's logits."""
    t, d, f, v = b * s, cfg.d_model, cfg.d_ff, cfg.vocab_size
    hq, hkv = cfg.n_heads * cfg.resolved_head_dim, cfg.n_kv_heads * cfg.resolved_head_dim
    layer = 2 * t * d * (2 * hq + 2 * hkv) + 2 * t * d * f * 3
    return cfg.n_layers * layer + 2 * b * d * v


def test_smoke_cell_on_a_4_rank_fake_mesh(fake_pg, tmp_path, monkeypatch):
    cfg = get_config("yi-6b").smoke()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    b, s = 4, 16
    rec = dryrun.lower_cell("yi-6b", ShapeConfig("smoke_prefill", s, b, "prefill"),
                            (2, 2), ("data", "model"), verbose=False)
    assert rec["status"] == "ok" and rec["n_chips"] == 4
    assert rec["arg_devices"] == ["meta"]
    gemm = rec["flops_by_op"].get("aten.mm", 0) + rec["flops_by_op"].get("aten.bmm", 0)
    assert gemm * 4 == _gemm_flops(cfg, b, s)
    fa = rec["kernels"]["flash_attention"]
    assert cfg.n_kv_heads % 2                           # one kv head: heads whole
    assert fa["calls"] == cfg.n_layers
    assert fa["flops"] == cfg.n_layers * 4 * (b // 2) * cfg.n_heads * \
        cfg.resolved_head_dim * visible_pairs(s, s, True, None)
    assert rec["collective_by_axis"]["model"] > 0
    assert rec["roofline"]["flops_per_device"] == gemm + fa["flops"] + sum(
        n for op, n in rec["flops_by_op"].items() if op not in ("aten.mm", "aten.bmm"))
    path = tmp_path / "cells.jsonl"
    path.write_text(json.dumps(rec) + "\n")
    table = report.roofline_table(path, mesh="2x2")
    assert "| yi-6b × smoke_prefill |" in table and "+n/a |" in table
    assert "yi-6b × smoke_prefill" in report.compare_table(path, path, mesh="2x2")


def test_a_group_entry_shards_major_first(fake_pg):
    """``("pod", "data")`` on dim 0 of an (8, 3) tensor over a (2, 2) mesh:
    rank (p, d) holds rows ``(2p + d) * 2 ..``, the reference's
    major-to-minor order."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.dist.logical import placements
    from repro_torch.launch.mesh import make_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
        pl = placements((("pod", "data"), None), mesh)
        shape, offset = compute_local_shape_and_global_offset((8, 3), mesh, pl)
        p, d = mesh.get_coordinate()
        assert tuple(shape) == (2, 3)
        assert tuple(offset) == ((2 * p + d) * 2, 0), (rank, offset)
        with pytest.raises(NotImplementedError):
            placements((("data", "pod"),), mesh)
        dist.destroy_process_group()


def test_dryrun_launcher_single_cell(fake_pg, tmp_path):
    """``python -m repro_torch.launch.dryrun`` on one production cell (the
    256-rank fake mesh): exit 0, one record of status ok on meta, and
    ``report`` renders it."""
    out = tmp_path / "cells.jsonl"
    with pytest.raises(SystemExit) as ended:
        dryrun.main(["--arch", "whisper-small", "--shape", "prefill_32k",
                     "--out", str(out)])
    assert ended.value.code == 0
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["status"] == "ok" and rec["mesh"] == "32x8" and rec["n_chips"] == 256
    assert rec["arg_devices"] == ["meta"]
    assert rec["kernels"]["flash_attention"]["calls"] == 36   # 12 enc, 12 self, 12 cross
    assert "| whisper-small × prefill_32k |" in report.roofline_table(out)
