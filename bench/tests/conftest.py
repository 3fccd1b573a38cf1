"""Fixtures of the benchmark's CPU tests (``pytest bench/tests``; the
repository's own run collects ``tests/`` only)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH / "tests"), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def tiny_root(tmp_path):
    """A tiny copy of the benchmark (``tiny.make``) under ``tmp_path``."""
    import tiny

    return tiny.make(tmp_path / "root")


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none (decided here, not
    at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
