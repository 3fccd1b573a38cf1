"""Public entry point for ``sample``.

``sample(logits, temperature, ...)`` draws one token per row of ``(R, V)``
logits as the reference's ``jax.random.categorical`` does (see ref.py): the
CUDA kernel for a CUDA tensor, the plain PyTorch version for a CPU tensor.
A CUDA tensor never falls back to the plain version.  The temperature's
reciprocal is formed here (once per temperature and dtype).  The top-k
threshold goes by ``top_k``, never by failure: on the card, the kernel finds
it in the same launch for ``top_k <= TOP_K_CAP`` (256), and above the cap
it is formed here with ``torch.topk``, as the reference forms it outside
its kernel with ``jax.lax.top_k``; ``top_k >= V`` masks nothing.  On the
CPU the plain version takes the ``torch.topk`` threshold.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .kernel import TOP_K_CAP, sample_cuda
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
    inv_t = _inv_temperature(float(temperature), dtype)
    kw = dict(keys=key, split_key=split_key, seeds=seeds, index=index)
    if logits.device.type == "cuda":
        if TOP_K_CAP < top_k < logits.shape[-1]:
            kw["kth"] = top_k_threshold(logits, top_k, inv_t, dtype)
        else:
            kw["top_k"] = max(top_k, 0)
        return sample_cuda(logits, inv_t, dtype, **kw)
    if logits.device.type == "cpu":
        kth = top_k_threshold(logits, top_k, inv_t, dtype) if top_k > 0 else None
        return sample_ref(logits, inv_t, dtype, kth=kth, **kw)
    raise ValueError(f"sample: unsupported device {logits.device}")


_inv_temperature = functools.lru_cache(maxsize=64)(inv_temperature)
