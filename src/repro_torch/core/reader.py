"""Async span engine: pluggable I/O backends, zero-copy records, batched verify.

Algorithm 3's read phase, rebuilt for throughput.  The serial reference
path (kept in :func:`repro_torch.core.extract.extract` under ``workers=0`` for
the ablation benchmarks) does one ``seek()`` per record, walks the file
line by line in Python, decodes eagerly, and re-verifies one record at a
time.  This engine batches all four costs:

1. **Span coalescing** — offset-sorted targets within a file are merged
   into read spans whenever the byte gap between the provisional end of
   one record and the start of the next is at most ``coalesce_gap``.
   N nearby records then cost one I/O submission instead of N.
2. **Pluggable span backends** (:mod:`repro_torch.core.iobackend`) — *how*
   spans become bytes is delegated to a :class:`SpanBackend`:
   ``uring`` submits a depth-controlled window of spans to a raw
   io_uring ring and consumes completions in arrival order (one slow
   span never stalls the window); ``thread`` is the portable blocking
   ``preadv`` fallback; ``mmap`` maps whole files and serves spans as
   windows of the page cache.  Select with ``REPRO_READER_BACKEND`` /
   ``REPRO_READER_DEPTH`` (see :mod:`repro_torch.flags`) or per call.
3. **Zero-copy record views** — records are carved out of span buffers
   as :class:`~repro_torch.core.iobackend.RecordView` memoryview windows.  No
   ``bytes`` copy of a record exists anywhere; boundary scans
   (C-speed ``find(b"$$$$")``) run on the retained buffer, tail
   extensions (a record overrunning its provisional span) happen
   *before* views are carved (exported ``bytearray``\\ s cannot resize),
   and the single materialization is the lazy UTF-8 decode at the API
   boundary (``RecordView.text``), which also drops the buffer pin.
4. **Batched verification** (:mod:`repro_torch.core.verify`) — recomputed ids
   come from one vectorized cross-record pass per worker chunk, and a
   shared :class:`~repro_torch.core.verify.VerifyBatcher` leader-combines
   chunks across *all* workers (and, service-wide, across concurrent
   fetches) into single recompute/compare batches — on a CUDA verifier,
   one ``hash_mix`` digest pass for everything in flight.

Knob guidance: ``coalesce_gap`` trades wasted bytes for fewer
submissions (raise it on storage with expensive round trips; lower it
for very sparse target sets), ``span_guess`` should sit near the p90
record size (too small costs tail-extension reads — watch
``ReadStats.spans_read`` exceed span count; too large reads slack),
``depth`` (uring) bounds in-flight spans per worker — raise it on
high-latency storage, shrink it to bound buffer residency.

A :class:`~repro_torch.core.cache.RecordCache` can sit in front of the reads:
hits skip the I/O entirely, and hits that already carry a recomputed id
skip the structural re-parse too — a warm verified re-extraction touches
no file and parses nothing.
"""

from __future__ import annotations

import os
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

from repro_torch import flags

from ..device import DeviceLike
from .cache import RecordCache
from .iobackend import RecordView, SpanBackend, SpanBuffer, resolve_backend
from .records import find_record_end
from .verify import (
    VerifyBatcher,
    _recompute,
    compare_ids_batch,
)

__all__ = [
    "DEFAULT_COALESCE_GAP",
    "DEFAULT_SPAN_GUESS",
    "DEFAULT_WORKERS",
    "ReadEvent",
    "ReadStats",
    "Span",
    "coalesce_spans",
    "compare_ids_batch",
    "stream_plan",
]

# Provisional bytes fetched per record before its real end is known.  One
# page: records smaller than this cost a single aligned read with bounded
# overshoot; larger records extend by doubling.
DEFAULT_SPAN_GUESS = 4096
# Maximum unread bytes tolerated between two records before the span is
# split.  32 KiB rides out small inter-target gaps (page-cache readahead
# would fault them in anyway) without degenerating into whole-file reads
# for sparse target sets.
DEFAULT_COALESCE_GAP = 32 * 1024
# Hard cap on one coalesced span's read size: bounds per-worker resident
# memory on dense target sets (paper-scale files run to gigabytes; without
# the cap a dense plan would materialize a whole file per worker).  A
# single record larger than this still reads fully via tail extension.
DEFAULT_MAX_SPAN = 8 * 1024 * 1024
# Read workers: I/O-bound (pread releases the GIL), so oversubscribing a
# small host is fine and overlaps read with verify.
DEFAULT_WORKERS = min(8, 2 * (os.cpu_count() or 1))


@dataclass
class ReadStats:
    """I/O + verify accounting for one engine run (merged across workers)."""

    files_opened: int = 0
    spans_read: int = 0      # I/O submissions issued (spans + tail extensions)
    bytes_read: int = 0      # bytes actually read (incl. coalescing overshoot)
    cache_hits: int = 0      # records served without touching the file
    records: int = 0         # records handled (verified + mismatched)
    backend: str = ""        # span backend the run resolved to
    inflight_peak: int = 0   # max spans simultaneously in flight (one worker)
    verify_batches: int = 0  # physical combined verify batches
    verify_records: int = 0  # records that rode a verify batch
    verify_batch_max: int = 0  # largest combined batch observed

    def merge(self, other: "ReadStats") -> None:
        self.files_opened += other.files_opened
        self.spans_read += other.spans_read
        self.bytes_read += other.bytes_read
        self.cache_hits += other.cache_hits
        self.records += other.records
        self.backend = self.backend or other.backend
        self.inflight_peak = max(self.inflight_peak, other.inflight_peak)
        self.verify_batches += other.verify_batches
        self.verify_records += other.verify_records
        self.verify_batch_max = max(self.verify_batch_max, other.verify_batch_max)


class ReadEvent:
    """One record's outcome: ``ok`` (verified or verify=False) or not.

    ``payload`` is the record as read — a zero-copy
    :class:`~repro_torch.core.iobackend.RecordView` (or an already-decoded
    ``str`` off the cache); ``text`` decodes at first access.
    ``found_id`` is the recomputed canonical id when verification ran
    (``None`` under ``verify=False``); for a mismatch it is the id of the
    structurally different molecule the bytes actually held.
    """

    __slots__ = ("ok", "full_id", "key", "file", "offset", "payload",
                 "found_id")

    def __init__(self, ok, full_id, key, file, offset, payload, found_id):
        self.ok = ok
        self.full_id = full_id
        self.key = key
        self.file = file
        self.offset = offset
        self.payload = payload
        self.found_id = found_id

    @property
    def text(self) -> str:
        p = self.payload
        return p if isinstance(p, str) else p.text


@dataclass
class Span:
    """A merged read range covering one or more record starts."""

    start: int
    end: int                                    # provisional, exclusive
    members: List[Tuple[int, int]] = field(default_factory=list)  # (slot, off)


def coalesce_spans(
    offsets: Sequence[Tuple[int, int]],
    gap: int = DEFAULT_COALESCE_GAP,
    guess: int = DEFAULT_SPAN_GUESS,
    file_size: Optional[int] = None,
    max_span: int = DEFAULT_MAX_SPAN,
) -> List[Span]:
    """Merge ``(slot, offset)`` targets into read spans.

    Each record provisionally extends ``guess`` bytes past its start; a
    target joins the current span when its offset is at most ``gap`` bytes
    past the span's provisional end (``<=`` — a gap of exactly ``gap``
    bytes still merges) AND the merged span stays within ``max_span``
    bytes (memory bound per span buffer).  Ends are clamped to
    ``file_size`` when known.
    """
    if guess < 1:
        raise ValueError(f"span guess must be >= 1, got {guess}")
    if gap < 0:
        raise ValueError(f"coalesce gap must be >= 0, got {gap}")
    if max_span < 1:
        raise ValueError(f"max span must be >= 1, got {max_span}")
    ordered = sorted(offsets, key=lambda t: t[1])
    spans: List[Span] = []
    cur: Optional[Span] = None
    for slot, off in ordered:
        end = off + guess
        if file_size is not None:
            end = min(end, file_size)
        end = max(end, off)  # offsets at/past EOF: degenerate empty range
        if (
            cur is not None
            and off <= cur.end + gap
            and max(cur.end, end) - cur.start <= max_span
        ):
            cur.end = max(cur.end, end)
            cur.members.append((slot, off))
        else:
            cur = Span(start=off, end=end, members=[(slot, off)])
            spans.append(cur)
    return spans


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _carve_records(
    buf: SpanBuffer,
    members: Sequence[Tuple[int, int]],
    backend: SpanBackend,
    handle,
    guess: int,
    stats: ReadStats,
    payloads: List,
) -> None:
    """Resolve every member record's end in ``buf``, then carve views.

    Two passes on purpose: tail extensions resize the span's
    ``bytearray``, which is illegal once a memoryview is exported — so
    ALL ends are found (extending as needed) before ANY view is carved.
    """
    ends: List[Tuple[int, int, int]] = []
    for slot, off in members:
        rel = off - buf.base
        while True:
            end, _nxt, definite = find_record_end(buf.raw, rel, buf.at_eof)
            if definite:
                break
            if not backend.extend(handle, buf, guess, stats):
                # file exhausted (or unextendable backend): buffer end is EOF
                end, _nxt, _ = find_record_end(buf.raw, rel, True)
                break
        ends.append((slot, rel, max(end, rel)))
    for slot, rel, end in ends:
        payloads[slot] = RecordView(buf, rel, end)
    if ends:
        # Freeze the buffer NOW: with the shared memoryview exported, an
        # mmap close under live views raises (and is tolerated) instead
        # of silently invalidating them before their records decode.
        buf.view()


def _process_file(
    path,
    fname: str,
    items: Sequence[Tuple[str, str, int]],
    verify: bool,
    gap: int,
    guess: int,
    cache: Optional[RecordCache],
    verifier: VerifyBatcher,
    max_span: int,
    backend: SpanBackend,
    depth: int,
) -> Tuple[List[ReadEvent], ReadStats]:
    """One worker's unit: read, carve, and verify every target in a file."""
    stats = ReadStats()
    n = len(items)
    payloads: List = [None] * n          # RecordView | str (cache hits)
    rids: List[Optional[str]] = [None] * n

    to_read: List[int] = []
    if cache is not None:
        for i, (_fid, _key, off) in enumerate(items):
            hit = cache.get(fname, off)
            if hit is not None:
                payloads[i], rids[i] = hit
                stats.cache_hits += 1
            else:
                to_read.append(i)
    else:
        to_read = list(range(n))

    if to_read:
        handle = backend.open(path)
        stats.files_opened += 1
        try:
            fsize = backend.size(handle)
            spans = coalesce_spans(
                [(i, items[i][2]) for i in to_read], gap, guess, fsize, max_span
            )
            for span, buf in backend.read_spans(handle, spans, stats, depth):
                _carve_records(
                    buf, span.members, backend, handle, guess, stats, payloads
                )
        finally:
            backend.close_handle(handle)

    if verify:
        # records needing a cache (re-)insert: fresh reads, plus hits
        # cached without an id (a verify=False run) now being upgraded
        to_put = [i for i in range(n) if rids[i] is None] if cache is not None else ()
        ok, rids = verifier.verify(
            [it[0] for it in items], payloads, rids, stats
        )
        if cache is not None:
            for i in to_put:
                cache.put(fname, items[i][2], payloads[i], rids[i])
    else:
        ok = [True] * n
        if cache is not None:
            for i in to_read:
                cache.put(fname, items[i][2], payloads[i])

    events = [
        ReadEvent(
            ok=ok[i],
            full_id=full_id,
            key=key,
            file=fname,
            offset=off,
            payload=payloads[i],
            found_id=rids[i] if verify else None,
        )
        for i, (full_id, key, off) in enumerate(items)
    ]
    stats.records += n
    return events, stats


def stream_plan(
    store,
    plan: Dict[str, List[Tuple[str, str, int]]],
    *,
    verify: bool = True,
    workers: int = DEFAULT_WORKERS,
    coalesce_gap: int = DEFAULT_COALESCE_GAP,
    span_guess: int = DEFAULT_SPAN_GUESS,
    cache: Optional[RecordCache] = None,
    verify_backend: str = "auto",
    stats: Optional[ReadStats] = None,
    max_span: int = DEFAULT_MAX_SPAN,
    executor: Optional[ThreadPoolExecutor] = None,
    backend: Union[SpanBackend, str, None] = None,
    depth: Optional[int] = None,
    verifier: Optional[VerifyBatcher] = None,
    device: DeviceLike = "cuda",
) -> Iterator[ReadEvent]:
    """Stream :class:`ReadEvent`s for an extraction plan.

    ``plan`` is :func:`repro_torch.core.extract.plan_extraction` output
    (``{file_name: [(full_id, lookup_key, offset), ...]}``).  Files are
    fanned out over ``workers`` threads (``workers <= 1`` runs inline, in
    plan order); events for a file are emitted as soon as that file's
    records are verified, so downstream consumers overlap with reads still
    in flight.  Event order across files is completion order — callers
    needing determinism must reorder (``extract`` does).

    ``backend`` selects the span I/O backend: a
    :class:`~repro_torch.core.iobackend.SpanBackend` instance (borrowed — never
    closed here; how a service shares its rings across fetches), a name
    (``"uring"``/``"thread"``/``"mmap"``/``"auto"``), or ``None`` for the
    ``REPRO_READER_BACKEND`` env default.  ``depth`` bounds in-flight
    spans per worker (``None`` → ``REPRO_READER_DEPTH``).  ``verifier``
    lends a shared :class:`~repro_torch.core.verify.VerifyBatcher` (cross-call
    verify combining); by default one is built from ``verify_backend`` on
    ``device`` (the digest compare's device; default ``"cuda"``).

    At most ``2 * workers`` files are in flight at once (backpressure: a
    slow consumer of a huge plan never forces every file's records to sit
    in memory), and abandoning the generator early drops queued files
    instead of joining the whole extraction — in-flight io_uring spans
    are drained before their buffers are released.

    ``executor`` lends a long-lived pool (it is never shut down here) so
    hot-path callers — the training loader fetches every step — skip
    per-call pool construction.  ``stats`` (optional) accumulates merged
    I/O counters; per-file merges happen on the consuming thread, so
    reading it mid-iteration is safe.
    """
    if stats is None:
        stats = ReadStats()
    owned_backend: Optional[SpanBackend] = None
    if isinstance(backend, SpanBackend):
        be = backend
    else:
        be = owned_backend = resolve_backend(backend)
    stats.backend = stats.backend or be.name
    if depth is None:
        depth = flags.reader_depth()
    if verify_backend == "auto":
        verify_backend = flags.verify_backend()
    vf = (
        verifier if verifier is not None
        else VerifyBatcher(verify_backend, device=device)
    )
    args = dict(
        verify=verify,
        gap=coalesce_gap,
        guess=span_guess,
        cache=cache,
        verifier=vf,
        max_span=max_span,
        backend=be,
        depth=depth,
    )
    files = list(plan.items())
    try:
        if executor is None and (workers <= 1 or len(files) <= 1):
            for fname, items in files:
                events, fstats = _process_file(
                    store.path_of(fname), fname, items, **args
                )
                stats.merge(fstats)
                yield from events
            return

        owned = executor is None
        pool = executor if executor is not None else ThreadPoolExecutor(
            max_workers=workers
        )
        pending: set = set()
        todo = iter(files)
        max_inflight = max(2 * workers, 2)
        try:
            while True:
                for fname, items in todo:
                    pending.add(pool.submit(
                        _process_file, store.path_of(fname), fname, items, **args
                    ))
                    if len(pending) >= max_inflight:
                        break
                if not pending:
                    return
                done, pending = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    events, fstats = fut.result()
                    stats.merge(fstats)
                    yield from events
        finally:
            # An abandoned generator (consumer broke out of extract_iter)
            # must not stall until every in-flight file finishes: drop
            # queued files and return without joining the running ones.
            if owned:
                pool.shutdown(wait=False, cancel_futures=True)
            else:
                for fut in pending:
                    fut.cancel()
    finally:
        if owned_backend is not None:
            owned_backend.close()
