"""Fingerprint plane: packed bit-matrix sidecars for similarity search.

The byte-offset index answers *exact-key* lookups; the second query
modality the related work points at (Medina & White's molecular Bloom
filters, Vaskin et al.'s substructure prefilters) is *similarity*: screen
millions of fixed-width molecular fingerprints with a bitwise Tanimoto
coefficient and keep the top-k.  This module is the build-time half of
that plane:

* a **deterministic folded fingerprint** per record — character-shingle
  features of the record's canonical identifier text, each hashed with
  the splitmix64 remix the Bloom sidecars already use and folded into a
  fixed ``FP_BITS``-wide bit vector (the classic hashed-fingerprint
  construction: feature multiplicity is discarded, only presence folds
  in).  Pure function of the text, so any worker can regenerate any
  fingerprint and a republished shard's plane is byte-stable;
* the **packed layout** the Tanimoto kernel consumes: ``(N, W)`` uint32
  words per shard (``W = FP_BITS / 32``), row order identical to the
  shard's digest-sorted data columns, plus a precomputed per-row
  popcount column so the kernel's union term ``|q| + |d| - |q & d|``
  never re-counts the database side.

Fingerprints are *screens*, not identity: equal fingerprints do not mean
equal records (fold collisions are by design), which is exactly why the
serving contract returns scored candidates instead of asserting matches
— the byte-offset columns behind each hit remain the ground truth.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "DEFAULT_FP_BITS",
    "FP_WORD_BITS",
    "fingerprint_batch",
    "fold_fingerprint",
    "popcount_u32",
    "words_for",
]

DEFAULT_FP_BITS = 1024  # 32 uint32 words/row: VMEM-friendly, ~0.5% dense text
FP_WORD_BITS = 32
_SHINGLE = 3            # character trigrams: the text-feature shingle width

# splitmix64 finalizer (same public-domain mixer the Bloom sidecars use);
# duplicated rather than imported so this module stays dependency-free.
_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_MUL1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_MUL2 = np.uint64(0x94D049BB133111EB)

# per-plane salt folded into every shingle hash: bump to rev the format
_FP_SALT = np.uint64(0xF1A9_0B5E_7C3D_2001)

_POP_LUT = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _mix64(x: np.ndarray) -> np.ndarray:
    z = x + _SM_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SM_MUL1
    z = (z ^ (z >> np.uint64(27))) * _SM_MUL2
    return z ^ (z >> np.uint64(31))


def words_for(bits: int) -> int:
    """uint32 words per fingerprint row; ``bits`` must pack evenly."""
    if bits < FP_WORD_BITS or bits % FP_WORD_BITS:
        raise ValueError(
            f"fingerprint bits must be a positive multiple of "
            f"{FP_WORD_BITS}, got {bits}"
        )
    if bits & (bits - 1):
        # power of two keeps the fold a mask (and shard planes uniform)
        raise ValueError(f"fingerprint bits must be a power of two, got {bits}")
    return bits // FP_WORD_BITS


def popcount_u32(a: np.ndarray) -> np.ndarray:
    """Per-element 1-bit count of a uint32 array, as int32.

    ``np.bitwise_count`` (numpy >= 2) when present, else one gather
    through a 256-entry byte LUT — both exact, both vectorized.
    """
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(a).astype(np.int32)
    b = _POP_LUT[a.view(np.uint8)].reshape(*a.shape, 4)
    return b.sum(axis=-1, dtype=np.int32)


def _shingle_positions(text: str, bits: int) -> np.ndarray:
    """Folded bit positions of every length-3 byte shingle of ``text``."""
    raw = text.encode("utf-8")
    if len(raw) < _SHINGLE:
        raw = raw + b"\x00" * (_SHINGLE - len(raw))
    b = np.frombuffer(raw, dtype=np.uint8).astype(np.uint64)
    codes = (
        (b[:-2] << np.uint64(16)) | (b[1:-1] << np.uint64(8)) | b[2:]
    ) ^ _FP_SALT
    return (_mix64(codes) & np.uint64(bits - 1)).astype(np.int64)


def fold_fingerprint(text: str, bits: int = DEFAULT_FP_BITS) -> np.ndarray:
    """One packed fingerprint row: ``(W,)`` uint32, deterministic in ``text``."""
    w = words_for(bits)
    row = np.zeros(w, dtype=np.uint32)
    pos = _shingle_positions(text, bits)
    np.bitwise_or.at(
        row,
        pos >> np.int64(5),
        np.uint32(1) << (pos & np.int64(31)).astype(np.uint32),
    )
    return row


def fingerprint_batch(
    texts: Sequence[str], bits: int = DEFAULT_FP_BITS
) -> Tuple[np.ndarray, np.ndarray]:
    """Fingerprint a batch: ``(fps (N, W) uint32, popcounts (N,) int32)``.

    One vectorized fold pass over the concatenation of all shingles —
    per-row Python work is a slice bookkeeping loop, not hashing.
    """
    w = words_for(bits)
    n = len(texts)
    fps = np.zeros((n, w), dtype=np.uint32)
    if n:
        per_row: List[np.ndarray] = [_shingle_positions(t, bits) for t in texts]
        pos = np.concatenate(per_row)
        rows = np.repeat(
            np.arange(n, dtype=np.int64),
            np.fromiter((len(p) for p in per_row), np.int64, count=n),
        )
        flat = rows * w + (pos >> np.int64(5))
        np.bitwise_or.at(
            fps.reshape(-1),
            flat,
            np.uint32(1) << (pos & np.int64(31)).astype(np.uint32),
        )
    counts = popcount_u32(fps).sum(axis=1, dtype=np.int32) if n else \
        np.zeros(0, dtype=np.int32)
    return fps, counts
