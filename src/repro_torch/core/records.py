"""Delimited-record stores: the paper's SDF file substrate.

Structure Data Format (SDF) files are semi-structured text with
variable-length records terminated by a ``$$$$`` line.  Everything in this
module operates on *byte offsets* (files opened in binary mode), because —
as the paper stresses (§IV.B) — byte addressing is what makes ``seek()``
O(1); line addressing would degrade to O(k) sequential scans.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "RECORD_DELIM",
    "RecordStore",
    "find_record_end",
    "iter_records",
    "iter_record_offsets",
    "read_record_at",
    "extract_property",
    "record_properties",
]

RECORD_DELIM = b"$$$$"
_DELIM_LINE = b"$$$$\n"
_READ_CHUNK = 1 << 20  # 1 MiB buffered reads for sequential scans


@dataclass(frozen=True)
class RecordStore:
    """A directory of delimited record files (the "PubChem distribution").

    The paper's corpus: 354 files × ~500k records.  Files are discovered in
    sorted order so that ``file_id`` (the integer position used by compact
    index encodings) is stable.

    The sorted listing is computed once on first use and reused —
    ``files()``/``file_names()``/``total_bytes()`` sit inside per-file
    extraction and scan loops, and re-globbing the directory for each call
    is pure syscall waste on a corpus that almost never changes.  Callers
    that DO change the directory (incremental index updates) must
    :meth:`refresh` before relisting.
    """

    root: Path

    def __post_init__(self):
        object.__setattr__(self, "root", Path(self.root))
        object.__setattr__(self, "_files_cache", None)

    def files(self) -> List[Path]:
        cached = self._files_cache
        if cached is None:
            cached = sorted(self.root.glob("*.sdf"))
            object.__setattr__(self, "_files_cache", cached)
        return cached

    def refresh(self) -> "RecordStore":
        """Invalidate the cached listing (directory contents changed)."""
        object.__setattr__(self, "_files_cache", None)
        return self

    def file_names(self) -> List[str]:
        return [p.name for p in self.files()]

    def path_of(self, name: str) -> Path:
        return self.root / name

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for p in self.files())

    def __len__(self) -> int:
        return len(self.files())


def find_record_end(buf: bytes, rel: int, at_eof: bool) -> Tuple[int, int, bool]:
    """Locate the ``$$$$`` terminator line of the record starting at ``rel``.

    The single home of the delimiter-line grammar, shared by the bulk
    sequential scanners below and the pipelined extraction engine's span
    splitter (:mod:`repro_torch.core.reader`): a terminator is ``$$$$`` at a line
    start followed only by ``\\r``s before its newline (or before EOF) —
    exactly the per-line path's ``line.rstrip(b"\\n\\r") == b"$$$$"`` test,
    found with C-speed ``bytes.find`` instead of a line loop.  ``rel``
    must be a line start (record starts always are).

    Returns ``(end, next_start, definite)``: ``end`` is where the record's
    bytes stop (the terminator line's first byte, or ``len(buf)`` when no
    terminator exists before EOF); ``next_start`` is the position just past
    the terminator line (``end == next_start`` means no terminator was
    found — an unterminated trailing record).  ``definite=False`` means the
    buffer ended before the answer was certain (no delimiter yet, or a
    candidate whose line might continue past the buffer) — the caller must
    extend the buffer unless ``at_eof``.
    """
    n = len(buf)
    pos = rel
    while True:
        idx = buf.find(RECORD_DELIM, pos)
        if idx == -1:
            return n, n, at_eof
        if idx > 0 and buf[idx - 1] != 0x0A:
            pos = idx + 1  # mid-line "$$$$": record content
            continue
        j = idx + 4
        while j < n and buf[j] == 0x0D:
            j += 1
        if j >= n:
            # "$$$$\r*" flush against the buffer end: at EOF the per-line
            # path's rstrip accepts it; otherwise the line may continue.
            return idx, n, at_eof
        if buf[j] == 0x0A:
            return idx, j + 1, True
        pos = j  # "$$$$junk": record content, keep scanning


def _iter_delimited(path: Path) -> Iterator[Tuple[int, bytes, bool]]:
    """Yield ``(start_offset, raw_record_bytes, terminated)`` per record.

    The shared sequential-scan core: chunked binary reads split with
    :func:`find_record_end` instead of a per-line Python loop.
    ``terminated`` is False only for a trailing record with no closing
    delimiter.
    """
    with open(path, "rb") as f:
        buf = b""
        base = 0          # absolute file offset of buf[0]
        start = 0         # absolute offset of the current record's first byte
        at_eof = False
        while True:
            rel = start - base
            end, nxt, definite = find_record_end(buf, rel, at_eof)
            if definite:
                if nxt > end:  # terminator found
                    yield start, buf[rel:end], True
                    start = base + nxt
                    continue
                tail = buf[rel:]  # EOF with no terminator
                if tail.strip():
                    yield start, tail, False
                return
            # need more bytes: drop the consumed prefix, then refill
            if rel > 0:
                buf = buf[rel:]
                base = start
            chunk = f.read(_READ_CHUNK)
            if chunk:
                buf += chunk
            else:
                at_eof = True


def iter_records(path: Path) -> Iterator[Tuple[int, str]]:
    """Yield ``(byte_offset, record_text)`` for every record in ``path``.

    Sequential full-file scan (the index-construction primitive).  Offsets
    are byte positions of the first byte of each record.  The trailing
    ``$$$$`` line is not included in ``record_text``.
    """
    for start, raw, _terminated in _iter_delimited(path):
        yield start, raw.decode("utf-8", "replace")


def iter_record_offsets(path: Path) -> Iterator[int]:
    """Yield the byte offset of every record start (no parsing).

    This is ``ScanLineOffsets`` from Algorithm 2, fused with record
    detection: a single streaming pass that only tracks byte positions.
    Blank records (nothing but whitespace before the delimiter) carry no
    indexable content and are skipped, as before.
    """
    for start, raw, _terminated in _iter_delimited(path):
        if raw.strip():
            yield start


def read_record_at(path_or_handle, offset: int) -> str:
    """O(1) record fetch: ``seek(offset)`` then read until the delimiter.

    Algorithm 3 lines 6–7 (``seek`` + ``ReadUntilDelimiter``).  Accepts an
    open binary handle so that callers extracting many records from one
    file (grouped extraction) amortize the ``open()`` cost, as the paper's
    GroupByFilename optimization requires.
    """
    own = False
    if isinstance(path_or_handle, (str, Path)):
        f = open(path_or_handle, "rb", buffering=_READ_CHUNK)
        own = True
    else:
        f = path_or_handle
    try:
        f.seek(offset)
        buf: List[bytes] = []
        for line in f:
            if line.rstrip(b"\n\r") == RECORD_DELIM:
                break
            buf.append(line)
        return b"".join(buf).decode("utf-8", "replace")
    finally:
        if own:
            f.close()


def extract_property(record_text: str, name: str) -> Optional[str]:
    """Extract an SDF data item ``> <name>`` value (first line) or None."""
    tag = f"> <{name}>"
    lines = record_text.splitlines()
    for i, ln in enumerate(lines):
        if ln.strip() == tag:
            if i + 1 < len(lines):
                v = lines[i + 1].strip()
                return v if v else None
            return None
    return None


def record_properties(record_text: str) -> Dict[str, str]:
    """All SDF data items of a record as a dict (single-line values)."""
    props: Dict[str, str] = {}
    lines = record_text.splitlines()
    i = 0
    while i < len(lines):
        ln = lines[i].strip()
        if ln.startswith("> <") and ln.endswith(">"):
            name = ln[3:-1]
            val = lines[i + 1].strip() if i + 1 < len(lines) else ""
            props[name] = val
            i += 2
        else:
            i += 1
    return props
