"""Logit rows that put the sampler's chunk-and-fold to the test (numpy only,
made from a seed): shared by the CPU tests, which hold them against
``jax.random``, and the card tests, which import no JAX.

Row ``i`` of :func:`special_rows` is of kind ``(i + offset) % 4``:

0. the k-th largest value repeated across chunk boundaries: fewer than k
   logits above ``TIE``, more than k equal to it (at the ends of every
   chunk first), the rest below;
1. ``-inf`` logits at index 0, at the ends of chunks and at random;
2. fewer than k finite logits, the rest ``-inf`` (no finite one at k = 1);
3. logits on a grid of 1/8, so that many are equal, in float32 and after
   a bfloat16 rounding.
"""

import numpy as np

from repro_torch.kernels.sample.kernel import TOP_K_CAP, parts_for

TIE = 0.5
KINDS = 4
# the repo's vocabularies, and (R, V): one of them for each chunk count
# parts_for gives at R = 1 and at R = 8 (at R = 8 every V from 66,561 on
# gives 66)
VOCABS = (50280, 51865, 64000, 65536, 128256, 151936, 163840, 262144)
GEOMETRIES = sorted({(r, min(v for v in VOCABS if parts_for(r, v) == p))
                     for r in (1, 8) for p in {parts_for(r, v) for v in VOCABS}})
KS = (1, 40, TOP_K_CAP, TOP_K_CAP + 1, None)   # None: k = V


def k_id(k) -> str:
    return "V" if k is None else str(k)


def kind_offset(k) -> int:
    """A row kind to start from for each k of ``KS``, so that R = 1 meets
    every kind."""
    return KS.index(k) % KINDS


def chunk_ends(v: int, chunk: int) -> np.ndarray:
    """The first and last index of every chunk, in order."""
    starts = np.arange(0, v, chunk)
    return np.unique(np.concatenate([starts, np.minimum(starts + chunk, v) - 1]))


def special_rows(r: int, v: int, k: int, chunk: int, seed: int,
                 offset: int = 0) -> np.ndarray:
    """``(r, v)`` float32 logits, the rows of the kinds above for top-k
    ``k`` over chunks of ``chunk`` logits."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((r, v)) * 2).astype(np.float32)
    ends = chunk_ends(v, chunk)
    for i in range(r):
        kind = (i + offset) % KINDS
        row = lg[i]
        if kind == 0 and 0 < k < v:
            row[:] = TIE - 1 - np.abs(row)
            above = rng.choice(v, (k - 1) // 2, replace=False)
            row[above] = TIE + 1 + np.abs(rng.standard_normal(above.size))
            rest = np.setdiff1d(np.arange(v), above)
            equal = np.setdiff1d(ends, above)[: k + 3]
            more = k + 3 - equal.size
            if more > 0:
                free = np.setdiff1d(rest, equal)
                equal = np.concatenate([equal, rng.choice(free, min(more, free.size),
                                                          replace=False)])
            row[equal] = TIE
        elif kind == 1:
            row[rng.random(v) < 0.1] = -np.inf
            row[ends[::3]] = -np.inf
            row[0] = -np.inf
        elif kind == 2:
            finite = rng.choice(v, min(max(k // 2, 0), v), replace=False)
            keep = row[finite].copy()
            row[:] = -np.inf
            row[finite] = keep
        elif kind == 3:
            row[:] = np.round(row * 8) / 8
    return lg
