"""The remat policies of training (``flags.REMAT_POLICY``), on the CPU.

Under "names" (the default, as in the reference) each sublayer recomputes
on its own (``common.remat_sublayer``) and the residual stream between
sublayers is kept; under "nothing" each whole layer recomputes
(``common.remat_layer``).  The autograd graph is the same, so every
parameter's gradient must be equal bit for bit in float32, per family.
What differs is the forward work the backward pass re-runs: the matmul
that ends a sublayer.  Counted over the backward pass (which holds the
recomputation), "names" runs one matmul fewer per attention or dense FFN
sublayer that does not end its layer (the attention's ``wo``; on the
hybrid the mixer's ``wo`` or ``out_proj``), and the same as "nothing" on
the SSM family, whose layer is its mixer.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import flags
from repro_torch.configs import get_config
from repro_torch.models.registry import build_model

FAMILIES = ["yi-6b", "moonshot-v1-16b-a3b", "mamba2-1.3b", "jamba-1.5-large-398b",
            "whisper-small"]
MATMULS = {"mm", "bmm", "addmm", "baddbmm"}


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in MATMULS:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _model_and_batch(arch):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(2), "cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    rng = np.random.default_rng(4)
    b, s = 2, 24
    batch = {"tokens": torch.from_numpy(rng.integers(0, 259, (b, s))),
             "loss_mask": torch.from_numpy((rng.random((b, s)) < 0.9).astype(np.float32))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((b, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return cfg, api, model, batch


def _grads(api, model, batch, policy, monkeypatch):
    monkeypatch.setattr(flags, "REMAT_POLICY", policy)
    model.zero_grad(set_to_none=True)
    loss, _ = api.loss(model, batch)
    counter = _CountMatmuls()
    with counter:
        loss.backward()
    return ({n: p.grad.clone() for n, p in model.named_parameters()},
            float(loss.detach()), counter.n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_names_gradients_equal_nothing_bit_for_bit(arch, monkeypatch):
    cfg, api, model, batch = _model_and_batch(arch)
    g_nothing, l_nothing, mm_nothing = _grads(api, model, batch, "nothing", monkeypatch)
    g_names, l_names, mm_names = _grads(api, model, batch, "names", monkeypatch)
    assert l_names == l_nothing
    assert g_names.keys() == g_nothing.keys()
    for n, g in g_nothing.items():
        assert torch.equal(g_names[n], g), n
        assert g.abs().sum() > 0 or n.endswith("bias"), n
    # the matmuls the backward pass re-runs: one fewer per sublayer that
    # does not end its layer
    per_layer = {"dense": 1, "moe": 1, "ssm": 0, "hybrid": 1, "encdec": 1}[cfg.family]
    layers = cfg.n_layers
    if cfg.family == "encdec":   # encoder: attention; decoder: self and cross
        layers = cfg.n_enc_layers + 2 * cfg.n_layers
    assert mm_nothing - mm_names == per_layer * layers, (mm_nothing, mm_names)


def test_policy_flag_reads_as_the_reference(monkeypatch):
    monkeypatch.setattr(flags, "REMAT_POLICY", "names")
    assert flags.remat_policy() == ("attn_out", "ffn_out", "mixer_out")
    for other in ("nothing", "dots"):
        monkeypatch.setattr(flags, "REMAT_POLICY", other)
        assert flags.remat_policy() == ()
