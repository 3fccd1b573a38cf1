"""Plain PyTorch version of the ``sample`` kernel, and the port's copy of
the ``jax.random`` functions that the reference's serving samples with.

The reference draws a token with ``jax.random.categorical``: the Gumbel-max
trick, ``argmax(gumbel(key, shape, logits.dtype) + logits)``, whose noise
comes from the counter-based threefry-2x32 hash.  Every step is an integer
function of the key and the element's flat index, or a rounding of one, so
it can be repeated bit for bit (jax 0.9, ``jax_threefry_partitionable``
on, the default ``threefry2x32`` implementation):

* ``threefry2x32(k, (x0, x1))``: 20 rounds of add, rotate, xor, the key
  injected every 4 rounds (``jax._src.prng._threefry2x32_lowering``).
* ``prng_key(seed)`` is ``[0, seed]`` for a 32-bit seed; ``split(key, n)``
  is threefry over the counters ``(0, i)``, ``i < n``; ``fold_in(key, d)``
  is threefry over ``(0, d)``.
* ``random_bits32(key, shape)`` is ``y0 ^ y1`` of threefry over each
  element's row-major flat index as a 64-bit ``(hi, lo)`` counter; the
  16-bit-float draws keep only the low 8 bits of it (``uniform`` asks for
  8 bits when the mantissa has fewer than 8).
* ``uniform``: the mantissa's bits under the exponent of 1.0 (``bits >> 9
  | 0x3F800000`` in float32, ``(bits & 0xFF) >> 1 | 0x3F80`` in bfloat16),
  minus 1, scaled, then clamped below at ``minval``.
* ``gumbel`` (mode ``"low"``): ``-log(-log(uniform(tiny, 1)))``, each op
  rounded to the dtype.
* ``categorical``: ``argmax(gumbel + logits)``, the first maximum.  In the
  reference the logits are divided by the temperature inside ``jit``,
  which XLA turns into a product with the float32 reciprocal of the
  temperature in the logits' dtype: :func:`inv_temperature` and
  :func:`scale_logits`.

PyTorch has no ``+``, ``<<`` or ``>>`` for uint32 on every device, so the
integer work is in int64 holding values in ``[0, 2**32)`` (``& M32`` after
each add), as ``hash_mix``'s plain version does.  Keys are uint32 tensors
of shape ``(..., 2)``, as the reference's raw keys are.  The two ``log``
calls may differ from XLA's by an ulp, which can flip a token only where
two perturbed scores are that close; everything else is exact.

:func:`sample_ref` is the kernel's plain version: one draw per row of an
``(R, V)`` logits matrix, the key given (one for all rows, split first or
not, or one per row) or derived per row from a seed and a token index.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..hash_mix.ref import from_u32, to_u32

__all__ = [
    "DRAW_DTYPES", "M32", "TINY", "categorical", "fold_in", "gumbel",
    "inv_temperature", "prng_key", "random_bits32", "sample_bits", "sample_ref",
    "sample_scores", "scale_logits", "split", "threefry2x32", "top_k_mask",
    "top_k_threshold", "top_two_gap", "uniform", "uniform_of_bits",
]

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
TINY = 2.0 ** -126  # the smallest normal of float32 and of bfloat16
DRAW_DTYPES = (torch.float32, torch.bfloat16)

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0: IntLike, k1: IntLike, x0: IntLike,
                 x1: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32, 20 rounds, of the counter pairs ``(x0, x1)`` under
    the key ``(k0, k1)``: int64 tensors (or ints, one of the four a tensor)
    holding uint32 values, broadcast together → ``(y0, y1)`` int64."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def _halves(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(..., 2)`` uint32 (or int32) key → its two words as int64."""
    if key.shape[-1:] != (2,) or key.dtype not in (torch.uint32, torch.int32):
        raise ValueError(f"a key is (..., 2) uint32, got {tuple(key.shape)} {key.dtype}")
    k = from_u32(key.contiguous().view(torch.uint32))
    return k[..., 0], k[..., 1]


def _key(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    return to_u32(torch.stack(torch.broadcast_tensors(y0, y1), dim=-1))


def prng_key(seed: IntLike, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: ``[0, seed]`` as a
    ``(2,)`` uint32 key (an int in [-2**31, 2**32), taken modulo 2**32, as
    the reference's int32 and uint32 seeds are).  A tensor of seeds gives
    one key per element, ``(..., 2)``, on the tensor's device."""
    if isinstance(seed, torch.Tensor):
        lo = from_u32(seed.view(torch.uint32)) if seed.dtype in (
            torch.int32, torch.uint32) else seed.long() & M32
        return _key(torch.zeros_like(lo), lo)
    if not -(2**31) <= int(seed) < 2**32:
        raise ValueError(f"a seed is a 32-bit integer, got {seed}")
    return to_u32(torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                               device=device))


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: ``(n, 2)`` keys, threefry of the
    counters ``(0, i)``."""
    k0, k1 = _halves(key)
    if k0.ndim:
        raise ValueError(f"split takes one (2,) key, got {tuple(key.shape)}")
    y0, y1 = threefry2x32(k0, k1, 0, torch.arange(n, device=key.device))
    return _key(y0, y1)


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter ``(0,
    data mod 2**32)``; ``key (..., 2)`` and ``data`` broadcast."""
    k0, k1 = _halves(key)
    if isinstance(data, torch.Tensor):
        d = (from_u32(data.view(torch.uint32)) if data.dtype in (torch.int32, torch.uint32)
             else data.long() & M32)
    else:
        d = int(data) & M32
    y0, y1 = threefry2x32(k0, k1, 0, d)
    return _key(y0, y1)


def _bits(k0: torch.Tensor, k1: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """``y0 ^ y1`` of threefry over 64-bit ``counters`` (int64, >= 0)."""
    y0, y1 = threefry2x32(k0, k1, counters >> 32, counters & M32)
    return y0 ^ y1


def random_bits32(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: ``y0 ^ y1`` over each
    element's row-major flat index, as uint32."""
    k0, k1 = _halves(key)
    n = math.prod(shape)
    bits = _bits(k0, k1, torch.arange(n, dtype=torch.int64, device=key.device))
    return to_u32(bits).reshape(tuple(shape))


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 ``x`` rounded to ``dtype`` (nearest, ties to even), kept in
    float32."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _check_draw(dtype: torch.dtype) -> None:
    if dtype not in DRAW_DTYPES:
        raise TypeError(f"draws are float32 or bfloat16, not {dtype}")


def _unit(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Random bits (int64) → ``[0, 1)`` floats of ``dtype`` (held in
    float32): the mantissa's bits under the exponent of 1.0, minus 1."""
    if dtype == torch.float32:
        one_to_two = (bits >> 9) | 0x3F800000
    else:  # 8 random bits, 7 of them in the mantissa
        one_to_two = (((bits & 0xFF) >> 1) | 0x3F80) << 16
    return to_u32(one_to_two).view(torch.float32) - 1.0


def _uniform(bits: torch.Tensor, dtype: torch.dtype, minval: float,
             maxval: float) -> torch.Tensor:
    lo = _round(torch.tensor(minval, dtype=torch.float32), dtype)
    hi = _round(torch.tensor(maxval, dtype=torch.float32), dtype)
    span = _round(hi - lo, dtype)
    unit = _unit(bits, dtype)
    if dtype == torch.float32:
        # XLA fuses ``unit * span + lo`` into one fused multiply-add: the
        # product of two float32 values is exact in float64
        f = (unit.double() * span.double() + lo.double()).float()
    else:
        f = _round(_round(unit * span, dtype) + lo, dtype)
    return torch.maximum(f, lo.to(f.device))


def uniform(key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype = torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for float32
    and bfloat16."""
    _check_draw(dtype)
    k0, k1 = _halves(key)
    n = math.prod(shape)
    bits = _bits(k0, k1, torch.arange(n, dtype=torch.int64, device=key.device))
    return _uniform(bits, dtype, minval, maxval).to(dtype).reshape(tuple(shape))


def _gumbel(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gumbel noise (mode ``"low"``) of ``dtype``, in float32, from random
    bits: ``u`` is 0 or at least 2**-23, so ``u * 1 + tiny`` clamped at
    ``tiny`` is ``max(u, tiny)``."""
    u = uniform_of_bits(bits, dtype)
    return -_round(torch.log(_round(-torch.log(u), dtype)), dtype)


def gumbel(key: torch.Tensor, shape: Sequence[int],
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)`` in mode ``"low"``."""
    _check_draw(dtype)
    k0, k1 = _halves(key)
    n = math.prod(shape)
    bits = _bits(k0, k1, torch.arange(n, dtype=torch.int64, device=key.device))
    return _gumbel(bits, dtype).to(dtype).reshape(tuple(shape))


def inv_temperature(temperature: float, dtype: torch.dtype) -> float:
    """The factor the reference's ``logits / temperature`` multiplies by
    under ``jit``: the float32 reciprocal of the temperature rounded to
    the logits' dtype."""
    _check_draw(dtype)
    t = np.float32(torch.tensor(float(temperature), dtype=dtype).float().item())
    return float(np.float32(1.0) / t)


def scale_logits(logits: torch.Tensor, inv_t: float, dtype: torch.dtype) -> torch.Tensor:
    """``logits / temperature`` as the reference computes it in ``dtype``
    (:func:`inv_temperature`), held in float32."""
    return _round(logits.float() * inv_t, dtype)


def top_k_mask(lg: torch.Tensor, k: int) -> torch.Tensor:
    """The reference's top-k cut: ``where(lg < kth, -inf, lg)``, ``kth``
    the k-th largest of each row (ties kept)."""
    kth = torch.topk(lg, min(k, lg.shape[-1]), dim=-1).values[..., -1:]
    return torch.where(lg < kth, float("-inf"), lg)


def top_k_threshold(logits: torch.Tensor, k: int, inv_t: float,
                    dtype: torch.dtype) -> torch.Tensor:
    """Each row's k-th largest scaled logit ``(R,)`` float32, the threshold
    under which :func:`sample_ref` and the kernel mask a logit.  Scaling
    rounds monotonically, so it is the k-th largest raw logit, scaled."""
    kth = torch.topk(logits, min(k, logits.shape[-1]), dim=-1).values[:, -1]
    return scale_logits(kth, inv_t, dtype).contiguous()


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` (float32 or
    bfloat16 logits, already scaled): ``argmax(gumbel + logits)``, the
    first maximum, int64.  A ``(2,)`` key draws over the whole array
    (counters over its flat index); an ``(R, 2)`` key draws each of the
    ``R`` rows of ``(R, V)`` logits under its own key, as ``vmap`` of it
    does."""
    _check_draw(logits.dtype)
    k0, k1 = _halves(key)
    v = logits.shape[-1]
    if k0.ndim:
        counters = torch.arange(v, device=logits.device).expand(logits.shape)
        bits = _bits(k0[:, None], k1[:, None], counters)
    else:
        n = logits.numel()
        counters = torch.arange(n, device=logits.device).reshape(logits.shape)
        bits = _bits(k0, k1, counters)
    score = _round(_gumbel(bits, logits.dtype) + logits.float(), logits.dtype)
    return torch.argmax(score, dim=-1)


def sample_bits(r: int, v: int, device, *, keys: Optional[torch.Tensor] = None,
                split_key: bool = False, seeds: Optional[torch.Tensor] = None,
                index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(R, V)`` random bits (int64 holding uint32) of a draw, from
    :func:`sample_ref`'s keys (``split_key`` advances ``keys`` in place)."""
    cols = torch.arange(v, dtype=torch.int64, device=device)
    if seeds is not None:
        k0, k1 = _halves(fold_in(prng_key(seeds), index))
        return _bits(k0[:, None], k1[:, None], cols)
    if keys is not None and keys.ndim == 2:
        k0, k1 = _halves(keys)
        return _bits(k0[:, None], k1[:, None], cols)
    if keys is None:
        raise ValueError("sample_ref needs keys, or seeds and index")
    if split_key:
        nxt, sub = split(keys)
        keys.copy_(nxt.view(keys.dtype))
        k0, k1 = _halves(sub)
    else:
        k0, k1 = _halves(keys)
    rows = torch.arange(r, dtype=torch.int64, device=device)[:, None]
    return _bits(k0, k1, rows * v + cols)


def uniform_of_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The uniform in ``[tiny, 1)`` that the Gumbel noise of ``dtype`` takes
    from random bits (float32 holding values of ``dtype``)."""
    return torch.clamp(_unit(bits, dtype), min=TINY)


def sample_scores(logits: torch.Tensor, inv_t: float, dtype: torch.dtype, *,
                  keys: Optional[torch.Tensor] = None, split_key: bool = False,
                  seeds: Optional[torch.Tensor] = None,
                  index: Optional[torch.Tensor] = None,
                  kth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``(R, V)`` float32 scores whose first maximum in each row
    :func:`sample_ref` takes (the arguments are its)."""
    _check_draw(dtype)
    r, v = logits.shape
    bits = sample_bits(r, v, logits.device, keys=keys, split_key=split_key,
                       seeds=seeds, index=index)
    lg = scale_logits(logits, inv_t, dtype)
    score = _round(_gumbel(bits, dtype) + lg, dtype)
    if kth is not None:
        score = torch.where(lg < kth[:, None], float("-inf"), score)
    return score


def sample_ref(logits: torch.Tensor, inv_t: float, dtype: torch.dtype, *,
               keys: Optional[torch.Tensor] = None, split_key: bool = False,
               seeds: Optional[torch.Tensor] = None,
               index: Optional[torch.Tensor] = None,
               kth: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw per row of ``(R, V)`` float32 or bfloat16 ``logits`` →
    ``(R,)`` int32 tokens, the noise and scores in ``dtype``.

    Each row's score is ``gumbel + logits * inv_t`` (rounded to ``dtype``
    after each op), ``-inf`` where the scaled logit is below ``kth`` (the
    row's ``(R,)`` float32 threshold, if given), and its token the first
    maximum.  The row's key and counters:

    * ``keys`` ``(2,)``: one key for the batch, over the flat index
      ``row * V + j`` (``categorical`` of the whole matrix).  With
      ``split_key`` the key is split first, ``key, sub = split(key)``: the
      draw uses ``sub`` and ``keys`` is overwritten in place by the new
      ``key``.
    * ``keys`` ``(R, 2)``: one key per row, counters ``j``.
    * ``seeds`` and ``index`` ``(R,)`` uint32 or int32: the row's key is
      ``fold_in(prng_key(seed), index)``, counters ``j``.
    """
    score = sample_scores(logits, inv_t, dtype, keys=keys, split_key=split_key,
                          seeds=seeds, index=index, kth=kth)
    return torch.argmax(score, dim=-1).to(torch.int32)


def top_two_gap(scores: torch.Tensor) -> torch.Tensor:
    """Each row's gap between its two largest scores, relative to
    max(1, |largest|): where a draw of the kernel and of the plain version
    may part (the ``log``s differ by an ulp) it is a few float32 ulps."""
    top2 = torch.topk(scores, min(2, scores.shape[-1]), dim=-1).values
    if top2.shape[-1] < 2:
        return torch.full(scores.shape[:-1], float("inf"), device=scores.device)
    return (top2[..., 0] - top2[..., 1]) / top2[..., 0].abs().clamp(min=1.0)
