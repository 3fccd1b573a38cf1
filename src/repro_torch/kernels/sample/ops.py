"""Public entry point for ``sample``.

``sample(logits, temperature, ...)`` draws one token per row of ``(R, V)``
logits as the reference's ``jax.random.categorical`` does (see ref.py): the
CUDA kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
A CUDA tensor never falls back to the plain version.  The temperature's
reciprocal and the top-k threshold (``torch.topk``) are formed here, once,
for either route.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import sample_cuda
from .ref import inv_temperature, sample_ref, top_k_threshold

__all__ = ["sample"]


def sample(logits: torch.Tensor, temperature: float, *,
           key: Optional[torch.Tensor] = None, split_key: bool = False,
           seeds: Optional[torch.Tensor] = None, index: Optional[torch.Tensor] = None,
           top_k: int = 0, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(R,)`` int32 tokens drawn from ``(R, V)`` logits at ``temperature``,
    the draw in ``dtype`` (default: the logits' own), the logits below each
    row's ``top_k``-th largest masked when ``top_k > 0``.

    Keys: ``key`` ``(2,)`` uint32 draws the whole batch under one key
    (``split_key``: split it first and leave the new key in ``key``, as the
    reference's static engine does each step); ``key`` ``(R, 2)`` one key
    per row; ``seeds`` and ``index`` ``(R,)`` uint32 or int32 the key
    ``fold_in(prng_key(seed), index)`` per row, as the reference's
    continuous engine does."""
    dtype = logits.dtype if dtype is None else dtype
    inv_t = inv_temperature(temperature, dtype)
    kth = top_k_threshold(logits, top_k, inv_t, dtype) if top_k > 0 else None
    kw = dict(keys=key, split_key=split_key, seeds=seeds, index=index, kth=kth)
    if logits.device.type == "cuda":
        return sample_cuda(logits, inv_t, dtype, **kw)
    if logits.device.type == "cpu":
        return sample_ref(logits, inv_t, dtype, **kw)
    raise ValueError(f"sample: unsupported device {logits.device}")
