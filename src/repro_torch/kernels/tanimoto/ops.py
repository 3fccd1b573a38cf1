"""Public entry point for ``tanimoto``.

``tanimoto_topk(q_fps, db_fps, k)`` — batched Tanimoto top-k of ``(Q, W)``
uint32 query fingerprints against an ``(N, W)`` uint32 plane:
``(scores (Q, k) float32, rows (Q, k) int32)`` ordered by ``(score desc,
row asc)`` with ``(-1.0, -1)`` pads.  A CUDA tensor launches the CUDA
kernel; a CPU tensor runs the plain PyTorch version.  A CUDA tensor never
falls back to the plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import tanimoto_topk_cuda
from .ref import tanimoto_topk_ref

__all__ = ["tanimoto_topk"]


def tanimoto_topk(
    q_fps: torch.Tensor,
    db_fps: torch.Tensor,
    k: int,
    q_counts: Optional[torch.Tensor] = None,
    db_counts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(scores, rows)``; see kernel/ref."""
    if q_fps.device.type == "cuda":
        return tanimoto_topk_cuda(q_fps, db_fps, k, q_counts, db_counts)
    if q_fps.device.type == "cpu" and db_fps.device.type == "cpu":
        return tanimoto_topk_ref(q_fps, db_fps, k, q_counts, db_counts)
    raise ValueError(
        f"tanimoto_topk: unsupported devices {q_fps.device} / {db_fps.device}"
    )
