"""The work of each hand-written kernel, from its shapes, and the dry-run's
counter of it.

:func:`attention_work`, :func:`attention_bwd_work` and :func:`scan_work`
give the floating-point operations a kernel (or the attention's backward)
must do (:func:`sample_work` the integer operations of the sampler,
:func:`tanimoto_work` the population counts of the similarity top-k) and
the bytes it must move (each input read once, each output written once)
for one call.  ``chip_smoke.py`` prices a
kernel's bound from them, and the dry-run (``launch/dryrun.py``) counts
the same work for every call the kernel gets on its ``meta`` branch, so a
kernel's work is reckoned one way whatever implements it.  The plain
versions' operations are not this work: the plain attention also computes
the (query, key) pairs its mask hides.

:func:`counting` opens a counter for the dynamic extent of a block;
:func:`record` adds one call to every open counter (and does nothing when
none is open).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Iterator, Optional, Tuple

__all__ = ["SAMPLE_INT_OPS", "attention_bwd_work", "attention_work", "counting",
           "record", "sample_select_work", "sample_top_k_work", "sample_work", "scan_work",
           "tanimoto_work", "visible_pairs"]

# 32-bit integer operations per logit of ``sample``: threefry-2x32's 20
# rounds of add, rotate and xor (60), the two words' first key addition
# (2) and five key injections of three adds (15), then the counter's add,
# the xor of the two words and the mantissa's shift and or (4)
SAMPLE_INT_OPS = 81


@functools.lru_cache(maxsize=256)
def visible_pairs(sq: int, skv: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a mask leaves visible: row p sits at position
    p + Skv - Sq and sees keys j < Skv with j <= it (causal) and j > it -
    window."""
    off, pairs = skv - sq, 0
    for p in range(sq):
        hi = min(p + off + 1, skv) if causal else skv
        lo = max(0, p + off - window + 1) if window is not None else 0
        pairs += max(0, hi - lo)
    return pairs


def attention_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                   causal: bool, window: Optional[int],
                   itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of ``flash_attention``'s forward: two products of D
    for each visible (query, key) pair and head; q and the output
    ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Skv, D)`` moved once."""
    flops = 4 * b * hq * d * visible_pairs(sq, skv, causal, window)
    nbytes = itemsize * b * d * (2 * hq * sq + 2 * hkv * skv)
    return flops, nbytes


def attention_bwd_work(b: int, hq: int, hkv: int, sq: int, skv: int, d: int,
                       causal: bool, window: Optional[int],
                       itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of ``flash_attention``'s backward: five products of
    D for each visible pair and head (S, dP, dV, dQ, dK; the forward
    supplies the rows' log-sum-exp, so the scores are not summed twice); q,
    the output and its gradient read and dq written, k and v read and
    their gradients written, and the float32 log-sum-exp and ``D =
    rowsum(dO * O)`` of each row, one pass each."""
    flops = 10 * b * hq * d * visible_pairs(sq, skv, causal, window)
    nbytes = itemsize * b * d * (4 * hq * sq + 4 * hkv * skv) + 2 * 4 * b * hq * sq
    return flops, nbytes


def scan_work(bh: int, c: int, p: int, n: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one ``ssd_scan``: a multiply and an add per state
    element; the float32 states read and the prefix states written, the
    decays read."""
    numel = bh * c * p * n
    return 2 * numel, 2 * numel * 4 + bh * c * 4


def sample_work(r: int, v: int, itemsize: int) -> Tuple[int, int]:
    """(32-bit integer operations, bytes) of one ``sample``: the threefry
    bits of every logit; the ``(R, V)`` logits read once and the ``(R,)``
    int32 tokens written."""
    return SAMPLE_INT_OPS * r * v, itemsize * r * v + 4 * r


def sample_top_k_work(r: int, v: int, itemsize: int, kept: int) -> Tuple[int, int]:
    """(32-bit integer operations, bytes) of one ``sample`` that masks each
    row below its top-k threshold: the threefry bits of the ``kept`` logits
    only (those at or above their row's threshold; the rest are masked
    whatever their noise) and one compare of every logit's key (the
    threshold is found by reading each at least once); the bytes are
    :func:`sample_work`'s.  Data-dependent: ``kept`` is k a row and the
    logits tied with the k-th."""
    return SAMPLE_INT_OPS * kept + r * v, itemsize * r * v + 4 * r


def sample_select_work(r: int, v: int, k: int, parts: int, chunk: int) -> int:
    """Key compares, at most, of the top-k threshold that ``sample``'s
    kernel finds in its launch (printed beside the bound): a
    chunk longer than k reads its keys in four passes of its radix select
    (fewer rounds and a maximum when one ends early) and a listing pass (a
    shorter chunk only lists them); the row's folding block reads the
    ``parts * k`` listed keys in four passes and one more, and the tie
    keys."""
    per_row = 5 * parts * k + parts
    for p in range(parts):
        n = min(chunk, v - p * chunk)
        per_row += 5 * n if n > k else n
    return r * per_row


def tanimoto_work(nq: int, n: int, w: int, k: int) -> Tuple[int, int]:
    """(population counts, bytes) of one ``tanimoto`` top-k: every query
    meets every row, W words each; the ``(N, W)`` plane and its ``(N,)``
    int32 counts read once, the queries and their counts read, and the
    ``(Q, k)`` float32 scores and int32 rows written."""
    return nq * n * w, n * (4 * w + 4) + nq * (4 * w + 4) + nq * k * 8


class _Counters(threading.local):
    def __init__(self):
        self.open: list = []


_COUNTERS = _Counters()


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, Dict[str, int]]]:
    """``{kernel name: {"calls", "flops", "bytes"}}`` of every
    :func:`record` inside the block."""
    counts: Dict[str, Dict[str, int]] = {}
    _COUNTERS.open.append(counts)
    try:
        yield counts
    finally:
        _COUNTERS.open.remove(counts)


def record(name: str, flops: int, nbytes: int) -> None:
    """Add one call of kernel ``name`` to every open counter."""
    for counts in _COUNTERS.open:
        c = counts.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        c["calls"] += 1
        c["flops"] += int(flops)
        c["bytes"] += int(nbytes)
