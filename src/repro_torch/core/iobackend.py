"""Span I/O backends: how coalesced spans become bytes in memory.

The extraction engine (:mod:`repro_torch.core.reader`) plans *what* to read —
coalesced ``[start, end)`` spans per file — and delegates *how* to a
:class:`SpanBackend`.  Three backends ship, selected by
``REPRO_READER_BACKEND`` (see :mod:`repro_torch.flags`) or per call:

``uring``
    Raw ``io_uring`` submission/completion rings driven through
    ``ctypes`` syscalls (no liburing dependency).  Spans are submitted as
    ``IORING_OP_READ`` SQEs in a depth-controlled window
    (``REPRO_READER_DEPTH`` in-flight spans), completions are reaped as
    they land, so one slow span never stalls the rest of the window.
    One ring per worker thread, owned by the backend instance and closed
    with it.  Linux only; availability is probed once per process.

``thread``
    ``os.preadv`` into a freshly allocated ``bytearray`` per span — the
    portable fallback.  Parallelism comes from the engine's file-worker
    fan-out (``pread`` releases the GIL); the submission window within a
    file is effectively 1.

``mmap``
    The whole file is mapped once (``PROT_READ``) and every span is a
    window into the mapping — no read syscalls at all, page faults do
    the I/O.  Fastest on page-cached corpora; record views pin the
    mapping until they are decoded (see below), and a file truncated
    under a live mapping can SIGBUS, so this backend is opt-in rather
    than the ``auto`` default.

``auto`` resolves to ``uring`` where the kernel supports it, else
``thread``.

Zero-copy lifecycle
-------------------
Every backend yields :class:`SpanBuffer`\\ s — a retained ``bytearray``
(or the file mapping) plus its absolute base offset.  The engine carves
records out as :class:`RecordView`\\ s: ``(buffer, start, stop)`` triples
whose bytes are only ever touched through ``memoryview`` slices.  No
``bytes`` copy of a record exists anywhere in the pipeline; the single
materialization is the lazy UTF-8 decode at the API boundary
(:attr:`RecordView.text`), which memoizes the string and *drops the
buffer reference* so verified-and-delivered records stop pinning their
span buffer (and, for ``mmap``, the mapping).

Tail extension (a record overrunning its provisional span) appends to
the span's ``bytearray`` and therefore must finish before any view is
exported — ``bytearray`` forbids resizing with live exports.  The engine
orders its work accordingly; :meth:`SpanBuffer.view` enforces it.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import sys
import threading
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch import flags

__all__ = [
    "RecordView",
    "SpanBuffer",
    "SpanBackend",
    "MmapBackend",
    "ThreadBackend",
    "UringBackend",
    "resolve_backend",
    "uring_available",
]

_MAX_EXTEND = 1 << 20  # tail-extension reads cap at 1 MiB per pread


class SpanBuffer:
    """One span's retained bytes: a ``bytearray`` or an ``mmap`` window.

    ``base`` is the absolute file offset of ``raw[0]``; ``fsize`` the
    file size at open, so :attr:`at_eof` tells the record splitter
    whether a missing delimiter is final or the buffer just ended early.
    """

    __slots__ = ("raw", "base", "fsize", "_mv")

    def __init__(self, raw, base: int, fsize: int):
        self.raw = raw
        self.base = base
        self.fsize = fsize
        self._mv: Optional[memoryview] = None

    @property
    def at_eof(self) -> bool:
        return self.base + len(self.raw) >= self.fsize

    def view(self) -> memoryview:
        """The shared memoryview over ``raw`` (created once, lazily).

        First call freezes the buffer: a ``bytearray`` with an exported
        view cannot be resized, so all tail extensions must happen
        before any record view is carved out.
        """
        mv = self._mv
        if mv is None:
            mv = self._mv = memoryview(self.raw)
        return mv

    @property
    def extendable(self) -> bool:
        return self._mv is None and isinstance(self.raw, bytearray)


class RecordView:
    """A record as a zero-copy window ``[start, stop)`` into a span buffer.

    ``text`` decodes lazily (UTF-8, ``replace``) straight from the
    memoryview — no intermediate ``bytes`` — memoizes the result, and
    releases the buffer reference: once a record crosses the API
    boundary it no longer pins its span buffer or file mapping.
    ``raw_range()`` exposes the undecoded bytes to the batched verifier
    (``None`` after the buffer has been released).
    """

    __slots__ = ("_buf", "start", "stop", "_text")

    def __init__(self, buf: SpanBuffer, start: int, stop: int):
        self._buf = buf
        self.start = start
        self.stop = stop
        self._text: Optional[str] = None

    def __len__(self) -> int:
        return self.stop - self.start

    @property
    def decoded(self) -> bool:
        return self._text is not None

    def raw_range(self) -> Optional[Tuple[object, int, int]]:
        """``(buffer_object, start, stop)`` for in-place byte scans
        (``find`` etc. need the buffer object, not a memoryview)."""
        buf = self._buf
        if buf is None:
            return None
        return buf.raw, self.start, self.stop

    def mem(self) -> Optional[memoryview]:
        buf = self._buf
        if buf is None:
            return None
        return buf.view()[self.start:self.stop]

    def slice_mem(self, a: int, b: int) -> memoryview:
        """Zero-copy window at *absolute buffer* coordinates (the batched
        verifier works in ``raw_range()`` coordinates)."""
        return self._buf.view()[a:b]

    @property
    def text(self) -> str:
        t = self._text
        if t is None:
            buf = self._buf
            t = str(buf.view()[self.start:self.stop], "utf-8", "replace")
            self._text = t
            self._buf = None  # decode boundary: stop pinning the buffer
        return t


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------

class SpanBackend:
    """How coalesced spans become :class:`SpanBuffer`\\ s.

    Instances are owned: the engine builds one per ``stream_plan`` call
    (or borrows a long-lived one from the service) and ``close()``\\ s it
    when owned.  All methods are thread-safe across file workers.
    """

    name = "?"

    def open(self, path) -> Tuple:
        fd = os.open(path, os.O_RDONLY)
        try:
            fsize = os.fstat(fd).st_size
        except OSError:
            os.close(fd)
            raise
        return (fd, fsize)

    def size(self, handle) -> int:
        return handle[1]

    def close_handle(self, handle) -> None:
        os.close(handle[0])

    def read_spans(self, handle, spans, stats, depth: int
                   ) -> Iterator[Tuple[object, SpanBuffer]]:
        raise NotImplementedError

    def extend(self, handle, buf: SpanBuffer, guess: int, stats) -> bool:
        """Grow ``buf``'s tail; False when the file is exhausted."""
        if not buf.extendable:
            return False
        fd = handle[0]
        step = min(max(guess, len(buf.raw)), _MAX_EXTEND)
        extra = os.pread(fd, step, buf.base + len(buf.raw))
        if not extra:
            return False
        stats.spans_read += 1
        stats.bytes_read += len(extra)
        buf.raw += extra
        return True

    def close(self) -> None:
        pass


class ThreadBackend(SpanBackend):
    """Portable fallback: one blocking ``preadv`` per span into a
    retained ``bytearray``.  Concurrency comes from the engine's file
    fan-out (``preadv`` releases the GIL)."""

    name = "thread"

    def read_spans(self, handle, spans, stats, depth: int):
        fd, fsize = handle
        for span in spans:
            length = max(0, span.end - span.start)
            buf = bytearray(length)
            if length:
                got = os.preadv(fd, [buf], span.start)
                if got < length:
                    del buf[got:]
            stats.spans_read += 1
            stats.bytes_read += len(buf)
            stats.inflight_peak = max(stats.inflight_peak, 1)
            yield span, SpanBuffer(buf, span.start, fsize)


class MmapBackend(SpanBackend):
    """Whole-file ``mmap``: spans are windows, reads are page faults.

    The fd is closed immediately after mapping (the mapping survives);
    the mapping itself is released when the last undecoded
    :class:`RecordView` lets go.  ``spans_read``/``bytes_read`` account
    the coalesced spans *touched*, to stay comparable with the pread
    backends.  Never needs tail extension — the buffer is the file.
    """

    name = "mmap"

    def open(self, path):
        fd = os.open(path, os.O_RDONLY)
        try:
            fsize = os.fstat(fd).st_size
            mm = mmap.mmap(fd, 0, prot=mmap.PROT_READ) if fsize else b""
        finally:
            os.close(fd)
        return (mm, fsize, SpanBuffer(mm, 0, fsize))

    def size(self, handle) -> int:
        return handle[1]

    def close_handle(self, handle) -> None:
        mm = handle[0]
        if isinstance(mm, mmap.mmap):
            try:
                mm.close()
            except BufferError:
                pass  # live record views pin the mapping; GC unmaps later

    def read_spans(self, handle, spans, stats, depth: int):
        mm, fsize, shared = handle
        # page faults are synchronous 4 KiB reads with no readahead on a
        # seeky mapping — keep a depth-deep madvise(WILLNEED) window ahead
        # of the carve so the kernel pulls upcoming spans in the
        # background, same in-flight discipline as the uring queue
        advise = getattr(mm, "madvise", None) if fsize else None
        willneed = getattr(mmap, "MADV_WILLNEED", None)
        ahead = 0
        for i, span in enumerate(spans):
            if advise is not None and willneed is not None:
                while ahead < len(spans) and ahead - i < depth:
                    sp = spans[ahead]
                    lo = (sp.start // mmap.PAGESIZE) * mmap.PAGESIZE
                    hi = min(sp.end, fsize)
                    if hi > lo:
                        try:
                            advise(willneed, lo, hi - lo)
                        except (OSError, ValueError):  # pragma: no cover
                            advise = None
                            break
                    ahead += 1
                stats.inflight_peak = max(stats.inflight_peak, ahead - i)
            else:
                stats.inflight_peak = max(stats.inflight_peak, 1)
            stats.spans_read += 1
            stats.bytes_read += max(0, min(span.end, fsize) - span.start)
            yield span, shared

    def extend(self, handle, buf, guess, stats) -> bool:
        return False  # the buffer already covers the whole file


# -- io_uring (raw syscalls, no liburing) -----------------------------------

_SYS_IO_URING_SETUP = 425
_SYS_IO_URING_ENTER = 426
_IORING_OFF_SQ_RING = 0
_IORING_OFF_SQES = 0x10000000
_IORING_ENTER_GETEVENTS = 1
_IORING_OP_READ = 22
_FEAT_SINGLE_MMAP = 1


class _UringParams(ctypes.Structure):
    # struct io_uring_params: 8 head fields + sq_off (8 u32 + u64) +
    # cq_off (8 u32 + u64), flattened.
    _fields_ = (
        [("sq_entries", ctypes.c_uint32), ("cq_entries", ctypes.c_uint32),
         ("flags", ctypes.c_uint32), ("sq_thread_cpu", ctypes.c_uint32),
         ("sq_thread_idle", ctypes.c_uint32), ("features", ctypes.c_uint32),
         ("wq_fd", ctypes.c_uint32), ("resv", ctypes.c_uint32 * 3)]
        + [(f"sq_{f}", ctypes.c_uint32) for f in
           ("head", "tail", "ring_mask", "ring_entries", "flags_off",
            "dropped", "array", "resv1")]
        + [("sq_user_addr", ctypes.c_uint64)]
        + [(f"cq_{f}", ctypes.c_uint32) for f in
           ("head", "tail", "ring_mask", "ring_entries", "overflow",
            "cqes", "flags_off", "resv1")]
        + [("cq_user_addr", ctypes.c_uint64)]
    )


_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(None, use_errno=True)
    return _libc


class _Ring:
    """One io_uring instance: setup, mmap'd rings, submit/reap."""

    def __init__(self, entries: int):
        libc = _get_libc()
        p = _UringParams()
        fd = libc.syscall(_SYS_IO_URING_SETUP, entries, ctypes.byref(p))
        if fd < 0:
            raise OSError(ctypes.get_errno(), "io_uring_setup failed")
        self.fd = fd
        self.p = p
        try:
            # ring sizes follow liburing: the index-array / cqe-array
            # offset plus the actual entry counts (sq_entries/cq_entries
            # are real counts; the p.sq_*/cq_* ring fields are OFFSETS)
            sq_size = p.sq_array + p.sq_entries * 4
            cq_size = p.cq_cqes + p.cq_entries * 16
            if p.features & _FEAT_SINGLE_MMAP:
                sq_size = cq_size = max(sq_size, cq_size)
            self.sq = mmap.mmap(
                fd, sq_size, flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQ_RING)
            self.cq = self.sq if p.features & _FEAT_SINGLE_MMAP else mmap.mmap(
                fd, cq_size, flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=0x8000000)
            self.sqes = mmap.mmap(
                fd, p.sq_entries * 64, flags=mmap.MAP_SHARED,
                prot=mmap.PROT_READ | mmap.PROT_WRITE,
                offset=_IORING_OFF_SQES)
        except Exception:
            os.close(fd)
            raise
        # The params' sq_*/cq_* fields are byte OFFSETS into the ring
        # mmaps; dereference the actual mask values once.
        self.sq_mask, = struct.unpack_from("<I", self.sq, p.sq_ring_mask)
        self.cq_mask, = struct.unpack_from("<I", self.cq, p.cq_ring_mask)
        self._sqe_idx = 0

    def prep_read(self, fd: int, addr: int, length: int, offset: int,
                  user_data: int) -> None:
        p = self.p
        idx = self._sqe_idx & self.sq_mask
        self._sqe_idx += 1
        # io_uring_sqe head: opcode, flags, ioprio, fd, off, addr, len,
        # rw_flags, user_data (rest of the 64 bytes zeroed)
        sqe = struct.pack("<BBHiQQIIQ", _IORING_OP_READ, 0, 0, fd,
                          offset, addr, length, 0, user_data)
        base = idx * 64
        self.sqes[base:base + len(sqe)] = sqe
        self.sqes[base + len(sqe):base + 64] = b"\0" * (64 - len(sqe))
        struct.pack_into("<I", self.sq, p.sq_array + idx * 4, idx)
        tail, = struct.unpack_from("<I", self.sq, p.sq_tail)
        struct.pack_into("<I", self.sq, p.sq_tail, tail + 1)

    def enter(self, to_submit: int, min_complete: int) -> None:
        libc = _get_libc()
        flags_ = _IORING_ENTER_GETEVENTS if min_complete else 0
        r = libc.syscall(_SYS_IO_URING_ENTER, self.fd, to_submit,
                         min_complete, flags_, 0, 0)
        if r < 0:
            err = ctypes.get_errno()
            if err == 4:  # EINTR: retry the wait (submissions consumed)
                return self.enter(0, min_complete)
            raise OSError(err, "io_uring_enter failed")

    def reap(self) -> List[Tuple[int, int]]:
        p = self.p
        head, = struct.unpack_from("<I", self.cq, p.cq_head)
        tail, = struct.unpack_from("<I", self.cq, p.cq_tail)
        out = []
        while head != tail:
            off = p.cq_cqes + (head & self.cq_mask) * 16
            user_data, res = struct.unpack_from("<Qi", self.cq, off)
            out.append((user_data, res))
            head += 1
        struct.pack_into("<I", self.cq, p.cq_head, head)
        return out

    def close(self) -> None:
        if self.fd >= 0:
            for m in {id(self.sq): self.sq, id(self.cq): self.cq,
                      id(self.sqes): self.sqes}.values():
                try:
                    m.close()
                except BufferError:  # pragma: no cover - defensive
                    pass
            os.close(self.fd)
            self.fd = -1


_URING_OK: Optional[bool] = None
_URING_PROBE_LOCK = threading.Lock()


def uring_available() -> bool:
    """Probe (once per process) whether io_uring setup+read works here —
    kernels and seccomp policies that expose the syscalls partially are
    common enough that only a full round trip counts."""
    global _URING_OK
    if _URING_OK is None:
        with _URING_PROBE_LOCK:
            if _URING_OK is None:
                _URING_OK = _probe_uring()
    return _URING_OK


def _probe_uring() -> bool:
    if not sys.platform.startswith("linux"):
        return False
    try:
        ring = _Ring(4)
    except OSError:
        return False
    try:
        buf = bytearray(16)
        cb = (ctypes.c_char * 16).from_buffer(buf)
        fd = os.open("/proc/self/cmdline", os.O_RDONLY)
        try:
            ring.prep_read(fd, ctypes.addressof(cb), 16, 0, 7)
            ring.enter(1, 1)
            done = ring.reap()
        finally:
            os.close(fd)
        del cb
        return len(done) == 1 and done[0][0] == 7 and done[0][1] >= 0
    except OSError:
        return False
    finally:
        ring.close()


class UringBackend(SpanBackend):
    """io_uring span submission with a depth-controlled in-flight window.

    Up to ``depth`` spans per file worker sit in the kernel at once;
    completions yield in arrival order, so the record splitter starts on
    whichever span lands first.  Short reads resubmit the remainder at
    the completed offset.  One ring per worker thread, lazily built and
    owned by this backend instance — ``close()`` (or the owning
    service/engine teardown) closes every ring fd.
    """

    name = "uring"

    def __init__(self):
        self._rings: Dict[int, _Ring] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _ring(self, depth: int) -> _Ring:
        tid = threading.get_ident()
        ring = self._rings.get(tid)
        if ring is None:
            entries = 8
            while entries < depth:
                entries <<= 1
            ring = _Ring(min(entries, 1024))
            with self._lock:
                if self._closed:
                    ring.close()
                    raise RuntimeError("backend closed")
                self._rings[tid] = ring
        return ring

    def read_spans(self, handle, spans, stats, depth: int):
        fd, fsize = handle
        depth = max(1, depth)
        ring = self._ring(depth)
        depth = min(depth, ring.p.sq_entries)
        # user_data -> [span, bytearray, ctypes_export, bytes_got]
        pending: Dict[int, list] = {}
        ready: deque = deque()  # reaped, not yet processed
        it = iter(spans)
        next_ud = 0
        exhausted = False
        try:
            while True:
                submitted = 0
                while not exhausted and len(pending) < depth:
                    span = next(it, None)
                    if span is None:
                        exhausted = True
                        break
                    length = max(0, span.end - span.start)
                    if length == 0:
                        stats.spans_read += 1
                        yield span, SpanBuffer(bytearray(), span.start, fsize)
                        continue
                    buf = bytearray(length)
                    # single-byte export: pins the buffer exactly like a
                    # full-length array would, but skips the per-length
                    # ctypes array-class construction (~6 µs/span)
                    cb = ctypes.c_char.from_buffer(buf)
                    ring.prep_read(fd, ctypes.addressof(cb), length,
                                   span.start, next_ud)
                    pending[next_ud] = [span, buf, cb, 0]
                    # pending[ud] must hold the ONLY export reference: a
                    # lingering local would block the bytearray resizes
                    # below (and the consumer's tail extensions)
                    del cb
                    next_ud += 1
                    submitted += 1
                if not pending and not ready:
                    return
                stats.inflight_peak = max(stats.inflight_peak, len(pending))
                if submitted or not ready:
                    ring.enter(submitted, 0 if ready else 1)
                ready.extend(ring.reap())
                while ready:
                    # popped BEFORE processing: an exception (or an
                    # abandoning consumer) mid-batch must not leave
                    # already-completed uds in pending for the drain
                    ud, res = ready.popleft()
                    ent = pending[ud]
                    if res < 0:
                        del pending[ud]
                        ent[2] = None
                        raise OSError(-res, os.strerror(-res))
                    ent[3] += res
                    span, buf = ent[0], ent[1]
                    got, want = ent[3], len(buf) - ent[3]
                    if res == 0 or want <= 0 or span.start + got >= fsize:
                        del pending[ud]
                        ent[2] = None  # release export before any resize
                        if got < len(buf):
                            del buf[got:]
                        stats.spans_read += 1
                        stats.bytes_read += got
                        yield span, SpanBuffer(buf, span.start, fsize)
                    else:  # short read mid-file: resubmit the remainder
                        cb = ctypes.c_char.from_buffer(buf)
                        ring.prep_read(fd, ctypes.addressof(cb) + got, want,
                                       span.start + got, ud)
                        ent[2] = cb
                        del cb
                        ring.enter(1, 0)
        finally:
            # An abandoned generator must not leave the kernel writing
            # into buffers we are about to free: discard completions
            # already reaped, then drain every span still in flight
            # (regular-file reads complete promptly).
            for ud, _res in ready:
                ent = pending.pop(ud, None)
                if ent is not None:
                    ent[2] = None
            while pending:
                ring.enter(0, 1)
                for ud, _res in ring.reap():
                    ent = pending.pop(ud, None)
                    if ent is not None:
                        ent[2] = None

    def close(self) -> None:
        with self._lock:
            self._closed = True
            rings, self._rings = self._rings, {}
        for ring in rings.values():
            ring.close()


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------

_BACKENDS = {
    "thread": ThreadBackend,
    "mmap": MmapBackend,
    "uring": UringBackend,
}


def resolve_backend(name: Optional[str] = None) -> SpanBackend:
    """Build a backend instance from a name (or the env default).

    ``None``/``"auto"`` reads ``REPRO_READER_BACKEND`` and falls through
    to ``uring`` where the probe passes, else ``thread``.  The caller
    owns the returned instance (``close()`` it — io_uring rings hold
    fds).
    """
    if name is None or name == "auto":
        name = flags.reader_backend()
    if name == "auto":
        name = "uring" if uring_available() else "thread"
    try:
        cls = _BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown reader backend {name!r} "
            f"(choose from auto/{'/'.join(sorted(_BACKENDS))})"
        ) from None
    return cls()
