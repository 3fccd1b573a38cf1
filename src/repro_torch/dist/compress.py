"""Gradient compression with error feedback, the port of
``repro.dist.compress``.

* **Lossy per-tensor compression**: :func:`quantize_int8` (symmetric int8,
  one float32 scale per tensor, or one per axis-0 slice) and a magnitude
  top-k sparsifier, :func:`topk_mask`.
* **Error feedback** (Seide et al. 2014, Karimireddy et al. 2019):
  :class:`ErrorFeedbackCompressor` keeps a float32 residual per parameter
  of what compression discarded and adds it back before compressing the
  next step, so ``sum compressed + residual == sum true`` holds exactly.

Gradients and residuals are ``{parameter name: tensor}`` dicts (the
module's ``named_parameters`` names).  A scale covers one *leaf*: by
default one tensor, and with ``leaves`` (``models.weights
.reference_layout``, as the train step passes it) the reference's leaf,
the stack of one parameter over every layer, whose axis 0 is the layer
(so ``per_channel`` means one scale per layer there, as in the
reference).  The trainer hooks a compressor
between the gradients and the AdamW update (:mod:`repro_torch.train.loop`),
chosen by ``TrainerConfig`` through :func:`make_compressor`.  The
arithmetic is the reference's, operation for operation, so the same
inputs give the same bits on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "ErrorFeedbackCompressor",
    "dequantize_int8",
    "make_compressor",
    "quantize_int8",
    "topk_mask",
]

Grads = Dict[str, torch.Tensor]

# Guards the scale against an all-zero tensor (0/0 → NaN grads downstream).
_MIN_SCALE = 1e-12


def quantize_int8(x: torch.Tensor,
                  per_channel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization → ``(q, scale)`` with ``q = round(x /
    scale)`` in [-127, 127] and ``scale = max|x| / 127`` (at least 1e-12).

    ``per_channel=True`` takes one scale per axis-0 slice (shape ``(d0, 1,
    ..., 1)``); a tensor of fewer than 2 dims falls back to one scale."""
    xf = x.float()
    if per_channel and xf.ndim >= 2:
        amax = torch.amax(torch.abs(xf), dim=tuple(range(1, xf.ndim)), keepdim=True)
    else:
        amax = torch.amax(torch.abs(xf))
    scale = torch.clamp(amax / 127.0, min=_MIN_SCALE)
    q = torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8` (float32; the scale broadcasts)."""
    return q.float() * scale


def topk_mask(x: torch.Tensor, frac: float) -> torch.Tensor:
    """Keep the ``frac`` largest-|x| entries (at least one), zero the rest;
    the threshold is the k-th largest |x| of a full sort, ties kept."""
    xf = x.float()
    flat = torch.abs(xf.reshape(-1))
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.sort(flat).values[flat.shape[0] - k]
    return torch.where(torch.abs(xf) >= thresh, xf, 0.0)


@dataclasses.dataclass
class ErrorFeedbackCompressor:
    """Per-tensor lossy compression + error-feedback residual.

    The residual dict lives in the train state under :attr:`state_key`
    (the trainer inits it with :meth:`init`, the checkpoint persists it).
    ``method`` is ``"int8"`` (default) or ``"topk"`` (at
    :attr:`topk_frac`); :attr:`per_channel` gives int8 axis-0 scales."""

    method: str = "int8"
    topk_frac: float = 0.1
    per_channel: bool = False
    state_key: str = "ef_residual"

    def __post_init__(self):
        if self.method not in ("int8", "topk"):
            raise ValueError(f"unknown compression method {self.method!r}")

    def init(self, params: Dict[str, torch.Tensor]) -> Grads:
        """Zero float32 residual, one tensor per parameter."""
        return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for n, p in params.items()}

    def _compress(self, g: torch.Tensor) -> torch.Tensor:
        if self.method == "topk":
            return topk_mask(g, self.topk_frac)
        q, s = quantize_int8(g, per_channel=self.per_channel)
        return dequantize_int8(q, s)

    def apply(self, grads: Grads, state: Dict[str, Any],
              leaves: Optional[Mapping[str, Tuple[Sequence[int], List[str]]]] = None,
              ) -> Tuple[Grads, Dict[str, Any]]:
        """Compress ``grads`` (+ the carried residual) → (the decompressed,
        wire-equivalent grads, ``state`` with the new residual).  ``state``
        is any dict holding the residual under :attr:`state_key`.
        ``leaves`` maps each leaf to ``(stack shape, [parameter names])``;
        without it every tensor is a leaf of its own."""
        residual = state[self.state_key]
        groups = (leaves.values() if leaves is not None
                  else [((), [n]) for n in grads])
        compressed: Grads = {}
        new_residual: Grads = {}
        for lead, names in groups:
            total = [grads[n].float() + residual[n] for n in names]
            shape = total[0].shape
            leaf = torch.stack(total).reshape(*lead, *shape) if lead else total[0]
            flat = self._compress(leaf).reshape(-1, *shape)
            for i, n in enumerate(names):
                compressed[n] = flat[i]
                new_residual[n] = total[i] - flat[i]
        new_state = dict(state)
        new_state[self.state_key] = new_residual
        return compressed, new_state


# name → constructor kwargs; the names TrainerConfig and the launcher take
_COMPRESSORS: Dict[str, Dict[str, Any]] = {
    "int8_ef": {"method": "int8"},
    "int8_pc_ef": {"method": "int8", "per_channel": True},
    "topk_ef": {"method": "topk"},
}


def make_compressor(name: Optional[str],
                    **overrides: Any) -> Optional[ErrorFeedbackCompressor]:
    """A compressor by name ("int8_ef", "int8_pc_ef", "topk_ef");
    None / "none" → None."""
    if name is None or name == "none":
        return None
    try:
        kwargs = dict(_COMPRESSORS[name])
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; choose from "
            f"{sorted(_COMPRESSORS)} or 'none'"
        ) from None
    kwargs.update(overrides)
    return ErrorFeedbackCompressor(**kwargs)
