"""Run-time knobs of the read engine, the residual layout under a mesh,
chunked decode attention and the training remat policy.

The read-engine knobs are read dynamically, not at import: tests and
launchers flip them per run.  The environment variable names are the
reference package's, so one setting drives both packages.

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


# Chunked decode attention (``models.common.decode_attention_chunked``, an
# online softmax over KV chunks) in place of the one-pass grouped products.
# Off by default, as in the reference.  Read once, at import; the decode
# paths read this attribute at call time, so a caller may flip it.
DECODE_CHUNKED = os.environ.get("REPRO_DECODE_CHUNKED", "0") == "1"

# Remat policy of the layer stacks while gradients are recorded
# (``models.common.remat_layer``), read at import; the layers read this
# attribute at call time:
#   "names"   - keep the attention, FFN and mixer outputs: each sublayer is
#               recomputed on its own, so the backward pass does not re-run
#               the matmul that ends a sublayer (the default, as in the
#               reference);
#   "nothing" - recompute each whole layer (the framework baseline).
REMAT_POLICY = os.environ.get("REPRO_REMAT_POLICY", "names")


def remat_policy():
    """The names of the sublayer outputs that the backward pass keeps:
    ``("attn_out", "ffn_out", "mixer_out")`` under "names", none under any
    other policy (the reference's ``nothing_saveable``)."""
    if REMAT_POLICY == "names":
        return ("attn_out", "ffn_out", "mixer_out")
    return ()


def residual_axes():
    """Logical axes of the residual stream ``(B, S, D)`` between layers."""
    return ("batch", "seq_sp", None) if SP_OUTPUTS else ("batch", "seq", None)
