"""The benchmark's yardstick: published peaks of the card, and the work
(operations and bytes) of a model's prefill, decode step and kernels,
counted from a configuration and the shapes it runs at.

The kernel formulas are a frozen copy of the port's ``kernels/work.py``
(``visible_pairs``, ``attention_work``, ``scan_work``), so a roofline share
reads the same work whatever implements the kernel, and a later change to
the program cannot move the yardstick.  Every count here is of useful work:
the model's matrices once per token, attention over the (query, key) pairs
a causal mask leaves visible, and each weight and cache byte read once.
"""

from __future__ import annotations

import functools
import importlib
from typing import Dict, Optional, Tuple

# NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates without sparsity
PEAK_FLOPS = 989e12        # bf16 tensor cores
HBM_BW = 3.35e12           # bytes/s


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two terms."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BW)


@functools.lru_cache(maxsize=4096)
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
    """(FLOPs, bytes) of one ``flash_attention`` forward: two products of D
    for each visible (query, key) pair and head; q and the output
    ``(B, Hq, Sq, D)``, k and v ``(B, Hkv, Skv, D)`` moved once."""
    flops = 4 * b * hq * d * visible_pairs(sq, skv, causal, window)
    nbytes = itemsize * b * d * (2 * hq * sq + 2 * hkv * skv)
    return flops, nbytes


def scan_work(bh: int, c: int, p: int, n: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one ``ssd_scan``: a multiply and an add per state
    element; the float32 states read and the prefix states written, the
    decays read."""
    numel = bh * c * p * n
    return 2 * numel, 2 * numel * 4 + bh * c * 4


def family(name: str):
    """The work of model family ``name``: ``bench/family_work/<name>.py``,
    with ``params(c)``, ``prefill(c, b, s, lengths)`` and ``decode(c,
    contexts)`` of a configuration file ``c``."""
    return importlib.import_module(f"family_work.{name}")
