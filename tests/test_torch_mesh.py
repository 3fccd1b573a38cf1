"""The port over a mesh, on the CPU: 2 processes over gloo.

Two groups of checks, each one spawn of 2 ranks (``torch_mesh_workers``),
one after the other, each given 240 s: a (1, 2) mesh, where heads, d_ff,
vocab and experts go over "model" (tensor and expert parallelism, the
sequence-parallel residual), and a (2, 1) mesh, where the batch and the
parameters' d_model go over "data" (data parallelism and FSDP).  On each:

* ``Engine.generate`` sharded equals unsharded for the five families
  (dense yi-6b, MoE moonshot, SSM mamba2, hybrid jamba, encoder-decoder
  whisper, smoke configs in f32): greedy tokens identical, the prefill's
  and the first decode step's logits within 1e-4 relative.  The MoE
  configs get a capacity that drops nothing: the capacity counts a dp
  shard's tokens, as in the reference, so with drops a sharded batch
  drops other assignments than the whole one (ROADMAP Queue 3);
* ``Trainer`` sharded equals unsharded over 3 steps (loss, grad norm and
  lr within 1e-4 relative; the final state within 1e-4 but for at most 1
  in 10,000 elements, each within AdamW's bound of two steps' moves):
  yi-6b on (1, 2), mamba2 on (2, 1), the MoE moonshot (no drops) on
  both, on (2, 1) without the router's aux loss (over "data" it is the
  mean of each shard's own, as in the reference: another loss); the
  sharded run's checkpoint restores into an unsharded port trainer and
  into the reference's trainer, equal to the sharded state it holds;
* a DTensor that reaches ``flash_attention`` or ``ssd_scan`` raises;
  ``constrain`` raises on a plain tensor under a mesh and lays a DTensor
  out as the rules say; a plain tensor that meets a DTensor raises unless
  ``replicate`` made it one; ``axis_rules({"experts": None})`` takes the MoE
  off the expert-parallel path with the same outputs; a backward run on
  another thread (as autograd runs a CUDA one) recomputes its blocks
  under the forward's mesh;
* ``launch.train --mesh 1x2`` and ``launch.serve --mesh 2x1`` run end to
  end (the serve launcher refuses ``--continuous`` with a mesh).
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_mesh_workers as W
from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.core import RecordStore as RRecordStore, build_index as r_build_index
from repro.data.pipeline import IndexedDataset as RIndexedDataset
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.trainer import Trainer as RTrainer, TrainerConfig as RTrainerConfig
from repro_torch.core import RecordStore, build_index
from repro_torch.core.sdfgen import CorpusSpec, generate_corpus
from repro_torch.data.pipeline import IndexedDataset
from repro_torch.models.weights import state_to_reference
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

RTOL = 1e-4
TIMEOUT_S = 240
TRAINERS = [("1x2", "yi-6b"), ("2x1", "mamba2-1.3b"),
            ("1x2", "moonshot-v1-16b-a3b"), ("2x1", "moonshot-v1-16b-a3b")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' rank-0 results (the ranks run the same checks), one
    group after the other: two more processes at a time beside the other
    test workers."""
    out = {}
    for group in W.GROUPS:
        tmp = tmp_path_factory.mktemp(f"mesh{group}")
        generate_corpus(tmp / "corpus", CorpusSpec(n_files=2, records_per_file=60,
                                                   salt="torch-mesh"))
        out[group] = (tmp, W.collect(W.spawn(group, tmp), tmp, TIMEOUT_S))
    return out


def _result(runs, group, name):
    tmp, results = runs[group]
    res = results[name]
    assert res["ok"], res.get("error")
    return tmp, res


@pytest.mark.parametrize("arch", W.ENGINE_ARCHS)
@pytest.mark.parametrize("group", list(W.GROUPS))
def test_engine_sharded_equals_unsharded(runs, group, arch):
    _, res = _result(runs, group, f"engine/{arch}")
    assert res["tokens"] == res["want"]
    assert res["prefill_rel"] <= RTOL, res["prefill_rel"]
    assert res["step_rel"] <= RTOL, res["step_rel"]
    assert res["original_untouched"]
    shards = [p for p in res["placements"] if "Shard" in p]
    assert shards, res["placements"]     # the layout really shards something


def _check_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= RTOL * abs(b[k]), (a["step"], k, a[k], b[k])


# AdamW moves an element by at most about lr a step (|m^|/sqrt(v^) <= 1.001
# over the first three steps for b1 = 0.9, b2 = 0.95): where an element's
# gradient is near 0, or a router near-tie flips one token's expert, two
# runs whose gradients round otherwise may step it apart by up to twice
# that.  So the final state holds RTOL for all but 1 in 10,000 elements of
# a tensor, and none of them leaves 2 x 1.001 x the lrs summed.
LRS = (1.5e-4, 3e-4, 3e-5)   # the three steps' learning rates (warmup 2)
STEP_BOUND = 2 * 1.001 * sum(LRS)


@pytest.mark.parametrize("group,arch", TRAINERS)
def test_trainer_sharded_equals_unsharded(runs, group, arch):
    _, res = _result(runs, group, f"trainer/{arch}")
    assert res["kinds"] == ["DTensor"]   # every parameter laid out over the mesh
    _check_history(res["sharded"], res["plain"])
    assert [h["lr"] for h in res["plain"]] == pytest.approx(LRS)
    for n, want in res["plain_state"].items():
        got, want = res["sharded_state"][n].float().numpy(), want.float().numpy()
        err = np.abs(got - want)
        outside = err > RTOL + RTOL * np.abs(want)
        assert outside.sum() <= want.size // 10_000, (n, int(outside.sum()))
        assert err.max() <= STEP_BOUND, (n, float(err.max()))


@pytest.mark.parametrize("group,arch", TRAINERS)
def test_sharded_checkpoint_restores_into_the_unsharded_port_and_repro(runs, group, arch):
    tmp, res = _result(runs, group, f"trainer/{arch}")
    saved = W.as_numpy(res["sharded_state"])
    common = dict(seq_len=W.SEQ, global_batch=W.BATCH, steps=3, ckpt_every=3)
    corpus = tmp / "corpus"

    cfg = W.smoke_cfg(arch)
    store = RecordStore(corpus)
    ds = IndexedDataset(store, build_index(store), W.SEQ, device="cpu")
    try:
        port = Trainer(cfg, TrainerConfig(**common, opt=AdamWConfig()), ds,
                       Path(res["ckpt"]).parent, device="cpu")
        step, state = port.maybe_restore(port.init_state())
    finally:
        ds.close()
    assert step == 3
    for n, t in state_to_reference(state).items():
        np.testing.assert_array_equal(t.float().numpy(), saved[n], err_msg=n)

    rcfg = dataclasses.replace(r_get_config(arch).smoke(), dtype="float32")
    if rcfg.n_experts:
        rcfg = dataclasses.replace(rcfg, capacity_factor=float(rcfg.n_experts))
    # the restore checks names and values only: the aux coefficient the
    # (2, 1) run trained with does not matter here
    rds = RIndexedDataset(RRecordStore(corpus), r_build_index(RRecordStore(corpus)), W.SEQ)
    ref = RTrainer(rcfg, RTrainerConfig(**common, opt=RAdamWConfig()), rds,
                   Path(res["ckpt"]).parent)
    rstep, rstate = ref.maybe_restore(ref.init_state())
    assert rstep == 3
    got = {n: np.asarray(a) for n, a in
           _flatten_with_names(jax.tree_util.tree_map(np.asarray, rstate))}
    for n, want in saved.items():
        np.testing.assert_array_equal(got[n].astype(np.float32), want, err_msg=n)


@pytest.mark.parametrize("group", list(W.GROUPS))
def test_a_dtensor_never_reaches_a_kernel_and_constrain_lays_out(runs, group):
    _, res = _result(runs, group, "guards")
    assert "DTensor reached the kernel" in res["flash_attention"]
    assert "DTensor reached the kernel" in res["ssd_scan"]
    assert "plain Tensor" in res["plain"]
    assert res["placements"] == res["want"]
    assert res["values_kept"]
    assert "mixed torch.Tensor and DTensor" in res["mixed"]
    assert res["replicated_sum"]


@pytest.mark.parametrize("group", list(W.GROUPS))
def test_moe_honours_axis_rule_override(runs, group):
    _, res = _result(runs, group, "moe_override")
    assert res["ep_rel"] <= RTOL and res["local_rel"] <= RTOL, res
    # the expert-parallel path averages each dp shard's aux loss (the
    # reference's pmean); without an expert axis the aux is the whole batch's
    a_ep, a_local, a_want, a_shards = res["aux"]
    assert abs(a_ep - a_shards) <= 1e-5 and abs(a_local - a_want) <= 1e-5
    assert res["dropped"] == 0 and res["top_i_equal"]


@pytest.mark.parametrize("group", list(W.GROUPS))
def test_backward_on_another_thread_recomputes_under_the_mesh(runs, group):
    _, res = _result(runs, group, "backward_thread")
    assert not res["alive"] and res["equal"]


def test_train_launcher_over_a_1x2_mesh(runs):
    _, res = _result(runs, "1x2", "launch/train")
    assert res["final_step"] == 2 and res["latest"] == 2
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))


def test_serve_launcher_over_a_2x1_mesh(runs):
    _, res = _result(runs, "2x1", "launch/serve")
    assert res["mesh"] == "2x1"
    # the launcher serves the bf16 smoke config: a sharded batch's products
    # round otherwise, so near-tied greedy tokens may flip (the f32 engine
    # checks above hold the tokens); every prompt gets its tokens
    assert len(res["tokens"]) == len(res["want"]) == len(W.PROMPTS)
    assert all(0 < len(t) <= 4 for t in res["tokens"])
    assert "--continuous" in res["refused"]
