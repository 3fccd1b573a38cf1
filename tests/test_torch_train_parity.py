"""The port's ``Trainer`` against the reference's, on the CPU.

From one shared checkpoint written by the reference's
``CheckpointManager`` (its step 0 state, f32 smoke configs of yi-6b,
gemma3-12b (its window cut to 16 of a row's 64 tokens, so that it masks),
moonshot-v1-16b-a3b, mamba2-1.3b and jamba-1.5-large-398b), both packages
train 3 steps on the same index-backed batches.  Per-step ``loss``,
``grad_norm`` and ``lr`` agree within 1e-4 relative and the final train
state (parameters, moments) within 1e-4 — both do the same float32
arithmetic in another order.  Once more with ``grad_accum=2`` and with
the ``int8_ef`` compressor.  Under ``int8_ef`` an element whose int8
quantum flips on an ulp difference of its gradient moves by up to one
AdamW step a step: at most 2 x 1.001 x lr per step (|m̂|/sqrt(v̂) <= 1.001
over the first three steps for b1 = 0.9, b2 = 0.95, by Cauchy-Schwarz);
fewer than 1 in 10,000 elements may leave 1e-4, none that bound, and the
error-feedback residual (which absorbs the flipped quantum and holds at
most half a quantum) is held to one quantum, twice its largest entry.  ``topk_ef`` is left out here: its ties flip on ulp
differences (``test_torch_train.py`` holds it bit for bit).

A port run that crashes at a step and resumes equals the uninterrupted
port run bit for bit; a checkpoint written by the port restores in the
reference and the reverse, and training continues equal.
"""

import dataclasses
import shutil
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import _flatten_with_names
from repro.configs import get_config as r_get_config
from repro.core import RecordStore as RRecordStore, build_index as r_build_index
from repro.core.sdfgen import CorpusSpec, generate_corpus
from repro.data.pipeline import IndexedDataset as RIndexedDataset
from repro.train.optimizer import AdamWConfig as RAdamWConfig
from repro.train.trainer import Trainer as RTrainer, TrainerConfig as RTrainerConfig
from repro_torch.configs import get_config
from repro_torch.core import RecordStore, build_index
from repro_torch.data.pipeline import IndexedDataset
from repro_torch.models.weights import state_to_reference
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

SEQ, BATCH = 64, 4
RTOL = 1e-4
OPT = dict(warmup_steps=2, total_steps=3)
LRS = (1.5e-4, 3e-4, 3e-5)   # the three steps' learning rates under OPT


@pytest.fixture(scope="module")
def corpus():
    root = Path(tempfile.mkdtemp()) / "c"
    generate_corpus(root, CorpusSpec(n_files=2, records_per_file=100, salt="torch-train"))
    return root


def _datasets(corpus):
    r = RIndexedDataset(RRecordStore(corpus), r_build_index(RRecordStore(corpus)), SEQ)
    store = RecordStore(corpus)
    return r, IndexedDataset(store, build_index(store), SEQ, device="cpu")


def _smoke(get, arch):
    """``arch``'s f32 smoke config; a window as wide as a batch row masks
    nothing, so gemma3's is cut to a quarter of one."""
    cfg = dataclasses.replace(get(arch).smoke(), dtype="float32")
    if cfg.window and cfg.window >= SEQ:
        cfg = dataclasses.replace(cfg, window=SEQ // 4)
    return cfg


def _trainers(arch, corpus, work, steps=3, ckpt_every=100, **kw):
    rcfg, cfg = _smoke(r_get_config, arch), _smoke(get_config, arch)
    common = dict(seq_len=SEQ, global_batch=BATCH, steps=steps, ckpt_every=ckpt_every, **kw)
    opt = dict(warmup_steps=2, total_steps=steps)
    rds, ds = _datasets(corpus)
    ref = RTrainer(rcfg, RTrainerConfig(**common, opt=RAdamWConfig(**opt)), rds, work / "ref")
    ours = Trainer(cfg, TrainerConfig(**common, opt=AdamWConfig(**opt)), ds, work / "port",
                   device="cpu")
    return ref, ours


def _ref_named(state):
    return {n: np.asarray(a) for n, a in
            _flatten_with_names(jax.tree_util.tree_map(np.asarray, state))}


def _check_history(got, want):
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for a, b in zip(got, want):
        for k in ("loss", "grad_norm", "lr"):
            assert abs(a[k] - b[k]) <= RTOL * abs(b[k]), (a["step"], k, a[k], b[k])


CASES = [
    ("yi-6b", 1, False), ("gemma3-12b", 1, False), ("moonshot-v1-16b-a3b", 1, False),
    ("mamba2-1.3b", 1, False),
    ("jamba-1.5-large-398b", 1, False),
    ("yi-6b", 2, False), ("jamba-1.5-large-398b", 2, False),
    ("mamba2-1.3b", 1, True), ("moonshot-v1-16b-a3b", 1, True),
]


@pytest.mark.parametrize("arch,grad_accum,int8", CASES,
                         ids=[f"{a}-ga{g}{'-int8_ef' if c else ''}" for a, g, c in CASES])
def test_trainer_matches_reference_from_one_checkpoint(corpus, tmp_path, arch, grad_accum,
                                                       int8):
    ref, ours = _trainers(arch, corpus, tmp_path, grad_accum=grad_accum,
                          compress_grads=int8, compressor="int8_ef")
    ref.ckpt.save(0, ref.init_state())      # the shared step-0 checkpoint
    shutil.copytree(ref.ckpt.root, ours.ckpt.root, dirs_exist_ok=True)
    r_final, r_state, r_hist = ref.run()
    final, state, hist = ours.run()
    assert final == r_final == 3 and int(state["step"]) == 3
    _check_history(hist, r_hist)
    got, want = state_to_reference(state), _ref_named(r_state)
    assert set(got) == set(want)
    bound = 2 * 1.001 * sum(LRS) + 1e-4
    for n, w in want.items():
        d = np.abs(got[n].float().numpy() - w.astype(np.float32))
        if not int8:
            assert d.max() <= 1e-4, (n, d.max())
        elif n.startswith("ef_residual/"):
            # a flipped quantum moves into the residual, which holds at most
            # half a quantum: the two differ by at most one, 2 max|residual|
            assert d.max() <= 2 * np.abs(w).max() + 1e-6, (n, d.max())
        else:
            assert d.max() <= bound and (d > 1e-4).mean() < 1e-4, (n, d.max())


def test_port_crash_and_resume_is_bit_exact(corpus, tmp_path):
    """Checkpoints every 2 steps; a run that dies at step 3 resumes from
    step 2 and gives the uninterrupted run's losses and state bit for bit."""
    arch = "jamba-1.5-large-398b"   # every kernel and the MoE on one path
    _, whole = _trainers(arch, corpus, tmp_path / "whole", steps=4, ckpt_every=2,
                         compress_grads=True)
    _, w_state, w_hist = whole.run()
    _, crash = _trainers(arch, corpus, tmp_path / "crash", steps=4, ckpt_every=2,
                         compress_grads=True)
    reached, _, _ = crash.run(die_at_step=3)
    assert reached == 3 and crash.ckpt.latest_step() == 2
    _, again = _trainers(arch, corpus, tmp_path / "crash", steps=4, ckpt_every=2,
                         compress_grads=True)
    final, state, hist = again.run()
    assert final == 4 and [h["step"] for h in hist] == [2, 3]
    for h in hist:
        w = next(x for x in w_hist if x["step"] == h["step"])
        assert (h["loss"], h["grad_norm"], h["lr"]) == (w["loss"], w["grad_norm"], w["lr"])
    a, b = state_to_reference(state), state_to_reference(w_state)
    assert set(a) == set(b)
    for n in a:
        assert torch.equal(a[n], b[n]), n


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_restore_across_packages(corpus, tmp_path, writer):
    """One package trains 2 steps and checkpoints (with the int8_ef
    residual); the other restores it and trains on to step 4, and so does
    the writer: the two continuations agree as the parity test's do."""
    arch = "yi-6b"
    kw = dict(steps=4, ckpt_every=2, compress_grads=True, compressor="int8_ef")
    ref, ours = _trainers(arch, corpus, tmp_path / "a", **kw)
    first = ours if writer == "port" else ref
    first.run(until_step=2)
    assert first.ckpt.latest_step() == 2
    ref2, ours2 = _trainers(arch, corpus, tmp_path / "b", **kw)
    second = ref2 if writer == "port" else ours2
    shutil.copytree(first.ckpt.root, second.ckpt.root, dirs_exist_ok=True)
    _, _, first_hist = (ours if writer == "port" else ref).run()
    _, _, second_hist = second.run()
    assert [h["step"] for h in first_hist] == [h["step"] for h in second_hist] == [2, 3]
    _check_history(second_hist, first_hist)
