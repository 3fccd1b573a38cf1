"""The categorical draw a served request's tokens are judged by: a frozen
copy of ``jax.random``'s threefry-2x32 key chain and Gumbel noise, as the
served engine's sampler documents it (float32 draws, mode "low").

A request's token ``k`` is the first maximum of ``gumbel(key_k) +
logits / T`` over the logits at or above the row's top-k threshold, with
``key_k = fold_in(prng_key(seed), k)`` and the noise over the vocabulary's
row-major index.  :func:`gap` reads how far a served token lies below the
choice that the same noise makes on the reference's logits.  Integer work
in int64 holding uint32 values.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["gap", "scores"]

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = 2.0 ** -126


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _noise(seeds: torch.Tensor, index: torch.Tensor, v: int) -> torch.Tensor:
    """(R, V) float32 Gumbel noise of rows keyed fold_in(prng_key(seed),
    index): prng_key(s) = (0, s); fold_in(k, d) = threefry_k(0, d); the
    bits of column j are y0 ^ y1 of threefry_key(0, j)."""
    zero = torch.zeros_like(seeds)
    k0, k1 = _threefry(zero, seeds & M32, zero, index & M32)
    cols = torch.arange(v, dtype=torch.int64, device=seeds.device)[None, :]
    y0, y1 = _threefry(k0[:, None], k1[:, None], torch.zeros_like(cols), cols)
    bits = y0 ^ y1
    unit = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    u = torch.clamp(unit, min=_TINY)
    return -torch.log(-torch.log(u))


def _inv_t(temperature: float) -> float:
    return float(np.float32(1.0) / np.float32(temperature))


def scores(logits: torch.Tensor, seeds: torch.Tensor, index: torch.Tensor,
           temperature: float, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, V) float32 perturbed scores of ``logits`` (unmasked), and each
    row's top-k threshold on the logits (``-inf`` without a cut)."""
    lg = logits.float()
    sc = _noise(seeds.long(), index.long(), lg.shape[1]) + lg * _inv_t(temperature)
    if top_k and top_k < lg.shape[1]:
        kth = torch.topk(lg, top_k, dim=-1).values[:, -1]
    else:
        kth = torch.full(lg.shape[:1], float("-inf"), device=lg.device)
    return sc, kth


def choice(logits, seeds, index, temperature: float, top_k: int) -> torch.Tensor:
    """The token the draw takes on ``logits``: (R,) int64."""
    sc, kth = scores(logits, seeds, index, temperature, top_k)
    return torch.where(logits.float() < kth[:, None], float("-inf"), sc).argmax(-1)


def gap(ref_logits: torch.Tensor, served: torch.Tensor, seeds: Optional[torch.Tensor],
        index: Optional[torch.Tensor], temperature: float, top_k: int) -> torch.Tensor:
    """(R,) float32, in logit units: how far the reference's logits would
    have to move for each served token to be their choice, 0 where they
    choose alike.  Greedy (``seeds`` None): the best logit less the served
    one.  Sampled, under the same noise: each token of the reference's
    top-k whose perturbed score beats the served one's must lose, either by
    its score falling to the served token's (``T`` times the difference)
    or by its logit falling out of the top-k (to the next logit after the
    k-th), whichever is less; and a served token outside the reference's
    top-k must rise to its threshold.  The gap is the most any one of
    these asks."""
    lg = ref_logits.float()
    rows = torch.arange(lg.shape[0], device=lg.device)
    s = served.to(lg.device).long()
    if seeds is None:
        return lg.max(-1).values - lg[rows, s]
    sc, kth = scores(lg, seeds.to(lg.device), index.to(lg.device), temperature, top_k)
    if top_k and top_k < lg.shape[1]:
        nxt = torch.topk(lg, top_k + 1, dim=-1).values[:, -1]
    else:
        nxt = torch.full_like(kth, float("-inf"))
    ahead = (lg >= kth[:, None]) & (sc > sc[rows, s][:, None])
    cost = torch.minimum(temperature * (sc - sc[rows, s][:, None]), lg - nxt[:, None])
    beat = torch.where(ahead, cost, torch.zeros_like(cost)).max(-1).values
    return torch.maximum(beat, torch.clamp(kth - lg[rows, s], min=0.0))
