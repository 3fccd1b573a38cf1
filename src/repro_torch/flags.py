"""Run-time knobs of the read engine, and the residual layout under a mesh.

Read dynamically, not at import: tests and launchers flip them per run.
The environment variable names are the reference package's, so one
setting drives both packages.

``REPRO_READER_BACKEND`` — span I/O backend for core.reader:
    "auto"   — io_uring when the kernel supports it, else "thread"
    "uring"  — raw io_uring submission queue (Linux; depth-controlled
               in-flight span windows, one enter() per window)
    "thread" — synchronous preadv per span (the portable fallback)
    "mmap"   — map whole files, serve records as zero-copy views of the
               page cache (no pread syscalls at all; opt-in: span/byte
               accounting semantics differ from the pread backends)
``REPRO_READER_DEPTH`` — target in-flight spans per uring submission window
    (default 32; clamped to the ring size).
``REPRO_VERIFY_BACKEND`` — id-recompute/compare mode for VerifyBatcher:
    "auto" (vectorized recompute; digest compare on a CUDA verifier, string
    compare on a CPU one), "vector", "process" (fork-pool recompute off the
    GIL), "string" / "digest" (per-record reference modes, combining
    disabled).
"""

from __future__ import annotations

import os


def reader_backend() -> str:
    return os.environ.get("REPRO_READER_BACKEND", "auto")


def reader_depth() -> int:
    return int(os.environ.get("REPRO_READER_DEPTH", "32"))


def verify_backend() -> str:
    return os.environ.get("REPRO_VERIFY_BACKEND", "auto")


# Sequence-parallel layer outputs (Megatron SP): under a mesh the attention,
# MLP and mixer outputs are constrained to the sequence-sharded residual
# layout ("seq_sp" → "model"), as the reference does; REPRO_SP_OUTPUTS=0
# keeps the residual's sequence whole.  Read once, at import, as the
# reference reads it.
SP_OUTPUTS = os.environ.get("REPRO_SP_OUTPUTS", "1") == "1"


def residual_axes():
    """Logical axes of the residual stream ``(B, S, D)`` between layers."""
    return ("batch", "seq_sp", None) if SP_OUTPUTS else ("batch", "seq", None)
