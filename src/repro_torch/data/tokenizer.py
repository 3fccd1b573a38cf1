"""Byte-level tokenizer for indexed-corpus LM training.

Vocabulary: 256 raw bytes + BOS/EOS/PAD specials.  Deterministic, needs no
training artifacts, and any vocabulary size ≥ 259 in the assigned configs
embeds it trivially (ids above 258 are simply never produced — the
embedding rows exist, which is what the shape cells exercise).

``render_example`` turns one SDF record into the training text: the
canonical id plus its computed property ("XLOGP3=…"), i.e. the
logP-prediction formulation the paper's final dataset targets.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.records import extract_property
from ..core.sdfgen import PROP_ID, PROP_XLOGP

__all__ = ["ByteTokenizer", "render_example"]

BOS = 256
EOS = 257
PAD = 258
VOCAB = 259


class ByteTokenizer:
    bos_id = BOS
    eos_id = EOS
    pad_id = PAD
    vocab_size = VOCAB

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")

    def pad_to(self, ids: List[int], length: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, loss_mask) both (length,); mask 0 on padding."""
        ids = ids[:length]
        out = np.full((length,), PAD, np.int32)
        out[: len(ids)] = ids
        mask = np.zeros((length,), np.float32)
        mask[: len(ids)] = 1.0
        return out, mask


def render_example(record_text: str) -> Optional[str]:
    """SDF record → training text (canonical id → property)."""
    full_id = extract_property(record_text, PROP_ID)
    if full_id is None:
        return None
    xlogp = extract_property(record_text, PROP_XLOGP)
    if xlogp is None:
        return None  # the paper's final-phase exclusion (missing property)
    return f"{full_id}\nXLOGP3={xlogp}"
