"""End-to-end trainer, the port of ``repro.train.trainer``: index-backed
data → the train step → catalog checkpoints, with restart built in.

Each step's batch is a pure function of ``(step, dp rank)``
(:class:`~repro_torch.data.sampler.GlobalSampler` over the
:class:`~repro_torch.data.pipeline.IndexedDataset`), so a restart from a
checkpoint sees the same data as the uninterrupted run.  Checkpoints hold
the train state under the reference's names
(:func:`~repro_torch.models.weights.state_to_reference`): a run of either
package resumes from the other's.  The device is explicit (``"cuda"`` by
default); a mesh (the distribution layer, ROADMAP Queue 1 item 10) is
not ported and raises.  The batches hold tokens only, as the reference's
do, so the encoder-decoder family, whose loss also reads audio frames,
cannot be trained here (:func:`require_token_model` raises); its loss and
gradients run through ``build_model(cfg).loss`` and autograd.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..data.pipeline import IndexedDataset
from ..data.sampler import GlobalSampler
from ..device import DeviceLike, resolve_device
from ..dist.compress import ErrorFeedbackCompressor, make_compressor
from ..models.registry import build_model
from ..models.weights import (
    load_state_reference,
    state_reference_names,
    state_to_reference,
)
from ..runtime.fault import Heartbeat
from .loop import make_train_state, make_train_step
from .optimizer import AdamWConfig

__all__ = ["Trainer", "TrainerConfig", "require_token_model"]


def require_token_model(cfg: ModelConfig) -> None:
    """Raise unless ``cfg``'s loss reads nothing but the tokens (and mask)
    that the trainer's batches hold."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family's loss reads audio frames "
            "(batch['frames']) and the trainer's batches hold tokens only (no "
            "frame source, as in the reference); train it through "
            "build_model(cfg).loss and autograd")


@dataclasses.dataclass
class TrainerConfig:
    seq_len: int = 128
    global_batch: int = 8
    steps: int = 50
    ckpt_every: int = 10
    keep_last: int = 3
    grad_accum: int = 1
    compress_grads: bool = False
    # a repro_torch.dist.compress name ("int8_ef", "int8_pc_ef", "topk_ef")
    # when compress_grads is set; topk_frac applies to topk only
    compressor: str = "int8_ef"
    topk_frac: float = 0.1
    seed: int = 0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)

    def make_compressor(self) -> Optional[ErrorFeedbackCompressor]:
        """The configured gradient compressor, or None when disabled."""
        if not self.compress_grads:
            return None
        return make_compressor(self.compressor, topk_frac=self.topk_frac)


class Trainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        tcfg: TrainerConfig,
        dataset: IndexedDataset,
        workdir: Path,
        mesh=None,
        dp_rank: int = 0,
        n_dp: int = 1,
        device: DeviceLike = "cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer over a mesh is not ported yet (ROADMAP Queue 1 item 10, "
                "the distribution layer); pass mesh=None"
            )
        require_token_model(model_cfg)
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.dataset = dataset
        self.workdir = Path(workdir)
        self.mesh = mesh
        self.dp_rank = dp_rank
        self.n_dp = n_dp
        self.device = resolve_device(device)
        self.api = build_model(model_cfg)
        self.sampler = GlobalSampler(
            n_examples=len(dataset),
            global_batch=tcfg.global_batch,
            seed=tcfg.seed,
        )
        self.ckpt = CheckpointManager(self.workdir / "ckpt", keep_last=tcfg.keep_last)
        self.heartbeat = Heartbeat(self.workdir, dp_rank)
        self._compressor = tcfg.make_compressor()
        self._step_fn = make_train_step(self.api, tcfg.opt, tcfg.grad_accum,
                                        self._compressor)

    # -- state --------------------------------------------------------------

    def init_state(self) -> Dict[str, Any]:
        """A fresh state, drawn from ``tcfg.seed`` on the trainer's device."""
        g = torch.Generator(device=self.device)
        g.manual_seed(self.tcfg.seed)
        state = make_train_state(self.api, g, self.tcfg.opt, self.device)
        if self._compressor is not None:
            state[self._compressor.state_key] = self._compressor.init(
                dict(state["model"].named_parameters())
            )
        return state

    def maybe_restore(self, state: Dict[str, Any]) -> Tuple[int, Dict[str, Any]]:
        """``(step, state)`` from the latest checkpoint, loaded into
        ``state`` in place; ``(0, state)`` when there is none."""
        if self.ckpt.latest_step() is None:
            return 0, state
        step, named = self.ckpt.restore(
            {n: None for n in state_reference_names(state)}, device=self.device)
        return step, load_state_reference(state, named)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Step ``step``'s batch of this dp rank, on the trainer's device."""
        batch_np = self.dataset.batch_for(self.sampler, step, self.dp_rank, self.n_dp)
        return {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}

    # -- run ----------------------------------------------------------------

    def run(
        self,
        until_step: Optional[int] = None,
        state: Optional[Dict[str, Any]] = None,
        on_step: Optional[Callable[[int, dict], None]] = None,
        die_at_step: Optional[int] = None,
    ) -> Tuple[int, Dict[str, Any], list]:
        """Train from the latest checkpoint (or ``state``) to ``until_step``
        → ``(step reached, state, history)``.

        ``die_at_step`` simulates a node failure: the trainer stops without
        a final checkpoint, like a SIGKILL (recovery must come from the
        last periodic checkpoint).  A step's record holds its ``loss``,
        ``grad_norm``, ``lr`` and ``dt`` (host seconds to the loss read
        back), and ``ckpt_s`` where a checkpoint followed it.
        """
        until = until_step if until_step is not None else self.tcfg.steps
        if state is None:
            start, state = self.maybe_restore(self.init_state())
        else:
            start = int(state["step"])
        history = []
        for step in range(start, until):
            batch = self.batch(step)
            t0 = time.perf_counter()
            state, metrics = self._step_fn(state, batch)
            loss = float(metrics["loss"])
            rec = {
                "step": step,
                "loss": loss,
                "grad_norm": float(metrics["grad_norm"]),
                "lr": float(metrics["lr"]),
                "dt": time.perf_counter() - t0,
            }
            history.append(rec)
            self.heartbeat.beat(step)
            if on_step:
                on_step(step, rec)
            done = step + 1
            if die_at_step is not None and done >= die_at_step:
                return done, state, history  # crashed: no checkpoint written
            if done % self.tcfg.ckpt_every == 0 or done == until:
                t0 = time.perf_counter()
                self.ckpt.save(done, state_to_reference(state),
                               meta={"loss": loss}, blocking=True)
                rec["ckpt_s"] = time.perf_counter() - t0
        return until, state, history
