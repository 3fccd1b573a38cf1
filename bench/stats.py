"""The percentiles the harness reports, over every sample."""

from __future__ import annotations

from typing import Sequence

__all__ = ["percentile"]


def percentile(xs: Sequence[float], q: float) -> float:
    """The ``q``-th percentile of all of ``xs``, interpolated linearly
    between the two nearest ranks (numpy's default)."""
    if not xs:
        raise ValueError("a percentile of no samples")
    s = sorted(xs)
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)

