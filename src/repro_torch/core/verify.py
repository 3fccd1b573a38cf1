"""Batched record verification — recompute-and-compare off the per-record path.

Algorithm 3's defensive verification recomputes every fetched record's
canonical id from its structural bytes and compares it against the id
the index promised.  Done record-at-a-time in Python
(:func:`repro_torch.core.identifiers.canonical_id_from_structure`) that costs
~50 µs/record — at bench scale it IS the cold read path (the I/O is a
few µs/record once spans coalesce).  This module batches it:

:func:`recompute_ids_batch`
    Cross-record *vectorized* recompute: every record's ctab block is
    located with C-speed byte scans, the atom/bond blocks of the whole
    batch are stacked into two numpy matrices (rows are the fixed-width
    38-/13-byte lines), counts, hydrogen totals, bond tuples and layout
    validity all come out of vectorized column arithmetic, and the
    canonical-id strings are assembled per record from precomputed
    fragment tables.  Any record that fails the strict layout validation
    (non-ASCII counts line, misaligned rows, non-digit fields, truncated
    block …) falls back to the reference parser for that record, so the
    output is *always* identical to per-record
    ``canonical_id_from_structure`` — including the ``<unparseable>``
    cases — just ~2x cheaper for well-formed corpora.

:class:`VerifyBatcher`
    Leader-combining verification across *all* engine workers: workers
    enqueue their (expected, payload) chunks, one leader drains the
    queue and runs a single combined recompute + compare — one
    vectorized pass (and, on a CUDA verifier, ONE ``hash_mix`` digest
    batch) instead of per-worker compares holding the GIL.  Backends:

    - ``vector``  — combined vectorized recompute, string compare;
    - ``process`` — combined recompute chunked over a process pool
      (off-GIL on multi-core hosts; record bytes are pickled to the
      children, which is the one copy this mode pays);
    - ``string``/``digest`` — the per-record reference recompute with a
      string / ``hash_mix``-digest compare (the legacy paths, kept for
      ablations and tests);
    - ``auto``    — ``vector`` recompute, with the compare riding the
      ``hash_mix`` device batch on a CUDA verifier, else the C-speed
      string compare.

The verifier's ``device`` (default ``"cuda"``) is where the digest compare
runs; the ``process`` backend's fork pool does host recompute only and
never touches CUDA.
"""

from __future__ import annotations

import atexit
import os
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..kernels.hash_mix.ops import hash_mix
from .identifiers import canonical_id_from_structure
from .iobackend import RecordView
from .packing import lanes_for, pack_ids

__all__ = [
    "VerifyBatcher",
    "compare_ids_batch",
    "recompute_ids_batch",
]

_UNPARSEABLE = "<unparseable>"

# structure_block's atom-line prefix: three fixed 0.0000 coords + space.
_ATOM_PREFIX = b"    0.0000    0.0000    0.0000 "
_PREFIX_ARR = np.frombuffer(_ATOM_PREFIX, np.uint8)
_ATOM_W = 38   # 37-char atom line + \n
_BOND_W = 13   # 12-char bond line + \n

def _recompute(text: str) -> str:
    """The reference per-record recompute (kept as ground truth)."""
    try:
        return canonical_id_from_structure(text)
    except ValueError:
        return _UNPARSEABLE


def _payload_text(p) -> str:
    if isinstance(p, str):
        return p
    if isinstance(p, RecordView):
        return p.text
    return bytes(p).decode("utf-8", "replace")


def _payload_ctx(p):
    """``(raw, lo, hi, mem_slicer)`` for byte-level parsing, or ``None``
    when only decoded text is available (cached strings, detached views)."""
    if isinstance(p, RecordView):
        rr = p.raw_range()
        if rr is None:
            return None
        raw, lo, hi = rr
        return raw, lo, hi, p.slice_mem
    if isinstance(p, (bytes, bytearray)):
        mv = memoryview(p)
        return p, 0, len(p), lambda a, b: mv[a:b]
    return None


def _scan_ctab(raw, lo: int, hi: int):
    """Locate + strictly validate the counts line of a record's ctab.

    Returns ``(natoms, nbonds, atom_block_start, bond_block_start)`` or
    ``None`` to send the record to the reference parser.  The fast path
    only accepts the FIRST ``V2000`` byte occurrence, on an all-ASCII
    line with nothing but whitespace after the tag — exactly the cases
    where byte-line splitting provably agrees with the reference's
    ``str.splitlines`` view (ASCII lines admit no hidden unicode line
    breaks).  Everything else falls back.
    """
    j = raw.find(b"V2000", lo, hi)
    if j < 0:
        return None
    nl = raw.rfind(b"\n", lo, j)
    ls = lo if nl < 0 else nl + 1
    le = raw.find(b"\n", j + 5, hi)
    if le < 0:
        le = hi
    line = bytes(raw[ls:le])
    if not line.isascii() or line[j + 5 - ls:].strip():
        return None
    # str.splitlines also breaks on \r \v \f \x1c-\x1e — a counts line
    # containing any of them reads differently to the reference parser
    if len(line.translate(None, b"\r\x0b\x0c\x1c\x1d\x1e")) != len(line):
        return None
    try:
        natoms = int(line[0:3])
        nbonds = int(line[3:6])
    except ValueError:
        return None
    if natoms < 0 or nbonds < 0:
        return None
    a0 = le + 1
    b0 = a0 + _ATOM_W * natoms
    if b0 + _BOND_W * nbonds > hi:
        return None  # truncated block: the reference's slicing semantics apply
    return natoms, nbonds, a0, b0


def recompute_ids_batch(payloads: Sequence) -> List[str]:
    """Canonical ids for a batch of records, vectorized across records.

    ``payloads`` may be :class:`~repro_torch.core.iobackend.RecordView`\\ s,
    raw ``bytes``, or decoded ``str`` (strings always take the reference
    parser).  Output is element-for-element identical to
    ``[_recompute(text) for text in batch]``.
    """
    n = len(payloads)
    ids: List[Optional[str]] = [None] * n
    metas: List[Tuple[int, int, int]] = []   # (slot, natoms, nbonds)
    atom_parts: List = []
    bond_parts: List = []
    fallback: List[int] = []

    for i, p in enumerate(payloads):
        ctx = _payload_ctx(p)
        if ctx is None:
            fallback.append(i)
            continue
        raw, lo, hi, mem = ctx
        m = _scan_ctab(raw, lo, hi)
        if m is None:
            fallback.append(i)
            continue
        natoms, nbonds, a0, b0 = m
        metas.append((i, natoms, nbonds))
        atom_parts.append(mem(a0, b0))
        bond_parts.append(mem(b0, b0 + _BOND_W * nbonds))

    if metas:
        _vector_ids(metas, atom_parts, bond_parts, ids, fallback)

    for i in fallback:
        ids[i] = _recompute(_payload_text(payloads[i]))
    return ids  # type: ignore[return-value]


def _bounds(widths, rows) -> List[int]:
    """Per-record byte boundaries into a globally space-stripped stream:
    cumulative nonspace widths, sampled at the record row offsets."""
    pos = np.zeros(len(widths) + 1, np.int64)
    np.cumsum(widths, out=pos[1:])
    return pos[rows].tolist()


def _vector_ids(metas, atom_parts, bond_parts, ids, fallback) -> None:
    nrec = len(metas)
    # One contiguous copy of just the ctab blocks — the batch's only
    # byte materialization (memoryview sources, so no per-record bytes).
    A = np.frombuffer(b"".join(atom_parts), np.uint8).reshape(-1, _ATOM_W)
    B = np.frombuffer(b"".join(bond_parts), np.uint8).reshape(-1, _BOND_W)
    na = np.fromiter((m[1] for m in metas), np.int64, nrec)
    nb = np.fromiter((m[2] for m in metas), np.int64, nrec)
    arow = np.zeros(nrec + 1, np.int64)
    np.cumsum(na, out=arow[1:])
    brow = np.zeros(nrec + 1, np.int64)
    np.cumsum(nb, out=brow[1:])
    seg_a = np.repeat(np.arange(nrec), na)
    seg_b = np.repeat(np.arange(nrec), nb)
    bad = np.zeros(nrec, bool)

    def isd(c):
        return (c >= 48) & (c <= 57)

    # ---- atom rows: layout validation + h totals + element codes ----------
    # Validation encodes "str(int(field)) == field.strip() and the field is
    # one whitespace-delimited token": digits only, no leading zeros, spaces
    # strictly leading.  Anything else (including 3-char element symbols,
    # which no supported element uses) sends the record to the reference
    # parser — the fast path only keeps rows whose byte layout provably
    # round-trips through the reference's split()/int() semantics.
    if len(A):
        ok = (A[:, :31] == _PREFIX_ARR).all(axis=1)
        ok &= (A[:, 34] == 32) & (A[:, 37] == 10)
        e0, e1, e2 = A[:, 31], A[:, 32], A[:, 33]
        nz = lambda c: (c > 32) & (c < 127)  # printable non-space: one token
        ok &= nz(e0) & (nz(e1) | (e1 == 32)) & (e2 == 32)
        h0, h1 = A[:, 35], A[:, 36]
        ok &= isd(h1) & ((isd(h0) & (h0 != 48)) | (h0 == 32))
        if not ok.all():
            bad[seg_a[~ok]] = True
        hval = (np.where(h0 == 32, 0, (h0 - 48).astype(np.int16) * 10)
                + (h1 - 48))
        ecode = (e0.astype(np.int16) << 8) | e1
        htot = np.bincount(seg_a, weights=hval, minlength=nrec).astype(np.int64)
        # element layer: strip spaces ONCE globally; per-record boundaries
        # come from the cumulative nonspace widths (exact even on invalid
        # rows, which only ever reach fallback records)
        EL = A[:, 31:33]
        el_s = EL.tobytes().replace(b" ", b"")
        el_b = _bounds((EL != 32).sum(axis=1), arow)
        # h layer: "d," / "dd," fragments, same global-strip trick
        HS = np.empty((len(A), 3), np.uint8)
        HS[:, 0] = h0
        HS[:, 1] = h1
        HS[:, 2] = 44  # ','
        hs_s = HS.tobytes().replace(b" ", b"")
        hs_b = _bounds((HS != 32).sum(axis=1), arow)
    else:
        ecode = np.zeros(0, np.int16)
        htot = np.zeros(nrec, np.int64)
        el_s = hs_s = b""
        el_b = hs_b = [0] * (nrec + 1)

    # ---- bond rows: validation + conn/stereo fragment slots ---------------
    if len(B):
        okb = B[:, 12] == 10
        Fw = B[:, :12].reshape(-1, 4, 3).astype(np.int16)
        c0, c1, c2 = Fw[..., 0], Fw[..., 1], Fw[..., 2]
        s0, s1 = c0 == 32, c1 == 32
        d0, d1 = isd(c0), isd(c1)
        okf = isd(c2) & (d1 | s1) & (d0 | s0) & ~(d0 & s1)
        okf &= ~(d0 & (c0 == 48)) & ~(s0 & d1 & (c1 == 48))  # leading zeros
        okb &= okf.all(axis=1)
        if not okb.all():
            bad[seg_b[~okb]] = True
        b_o = (np.where(d0[:, 2], c0[:, 2] - 48, 0) * 100
               + np.where(d1[:, 2], c1[:, 2] - 48, 0) * 10 + (c2[:, 2] - 48))
        b_st = (np.where(d0[:, 3], c0[:, 3] - 48, 0) * 100
                + np.where(d1[:, 3], c1[:, 3] - 48, 0) * 10 + (c2[:, 3] - 48))
        # conn fragments: fixed 12-byte slots "aaa-bbb[*ooo]," built from
        # the raw field bytes; the leading-zero rule above makes the
        # space-stripped slot equal the reference's f"{a}-{b}[*{o}]"
        CS = np.full((len(B), 12), 32, np.uint8)
        CS[:, 0:3] = B[:, 0:3]
        CS[:, 3] = 45   # '-'
        CS[:, 4:7] = B[:, 3:6]
        star = b_o != 1
        CS[star, 7] = 42  # '*'
        CS[star, 8:11] = B[star, 6:9]
        CS[:, 11] = 44  # ','
        conn_s = CS.tobytes().replace(b" ", b"")
        conn_b = _bounds((CS != 32).sum(axis=1), brow)
        # stereo layer: 4-byte "%3d," slots holding the 1-based bond
        # ordinal for st != 0 rows, all-spaces otherwise
        stnz = b_st != 0
        st_any = np.zeros(nrec, bool)
        if stnz.any():
            st_any[seg_b[stnz]] = True
            ordl = np.arange(len(B), dtype=np.int64) - np.repeat(brow[:-1], nb) + 1
            TS = np.full((len(B), 4), 32, np.uint8)
            o_ = ordl[stnz]
            hh, tt, uu = o_ // 100, (o_ // 10) % 10, o_ % 10
            TS[stnz, 0] = np.where(hh > 0, 48 + hh, 32)
            TS[stnz, 1] = np.where((hh > 0) | (tt > 0), 48 + tt, 32)
            TS[stnz, 2] = 48 + uu
            TS[stnz, 3] = 44  # ','
            st_s = TS.tobytes().replace(b" ", b"")
            st_b = _bounds((TS != 32).sum(axis=1), brow)
        else:
            st_s = b""
            st_b = [0] * (nrec + 1)
    else:
        st_any = np.zeros(nrec, bool)
        conn_s = st_s = b""
        conn_b = st_b = [0] * (nrec + 1)

    # ---- formula layer: per-record element counts, one bincount -----------
    K = 0
    names: List[str] = []
    if len(ecode):
        uniq, inv = np.unique(ecode, return_inverse=True)
        K = len(uniq)
        counts = np.bincount(seg_a * K + inv, minlength=nrec * K).reshape(nrec, K)
        names = [
            (chr((int(u) >> 8) & 0xFF) + chr(int(u) & 0xFF)).replace(" ", "")
            for u in uniq
        ]
    order = sorted(range(K), key=names.__getitem__)
    # Resolve carbon by its exact ("C", " ") code, not by name: invalid
    # rows of fallback-bound records can inject codes (e.g. (" ", "C"))
    # whose stripped NAME collides — good records never count those
    # columns (their rows are all valid, and name↔code is bijective over
    # valid codes), but an index-by-name could land on one.
    c_code = np.int16((ord("C") << 8) | 32)
    c_col = int(np.searchsorted(uniq, c_code)) if K else -1
    if c_col >= K or (K and uniq[c_col] != c_code):
        c_col = -1
    order_no_c = [k for k in order if k != c_col]
    # formula keys: the packed (counts..., htot) row — repeated formulas
    # (common in narrow corpora) memoize, the rest unpack via one Struct
    fkey_arr = np.empty((nrec, K + 1), np.uint32)
    if K:
        fkey_arr[:, :K] = counts
    fkey_arr[:, K] = htot
    fkey_bytes = fkey_arr.tobytes()
    FW = 4 * (K + 1)
    funpack = struct.Struct(f"<{K + 1}I").unpack
    fcache: Dict[bytes, str] = {}

    def build_formula(fk: bytes) -> str:
        vals = funpack(fk)
        h = vals[K]
        nc = vals[c_col] if c_col >= 0 else 0
        if nc:
            parts = [f"C{nc}"]
            if h:
                parts.append(f"H{h}")
            for k in order_no_c:
                v = vals[k]
                if v:
                    parts.append(f"{names[k]}{v}")
        else:
            # Hill order without carbon: H merges into the alphabetical
            # element list (and, as in the reference, *overwrites* any
            # atom-line "H" count).
            d = {names[k]: vals[k] for k in order if vals[k]}
            if h:
                d["H"] = h
            parts = [f"{el}{d[el]}" for el in sorted(d)]
        return "".join(parts)

    # ---- assembly: plain-python loop over pre-stripped byte slices --------
    bad_l, st_l = bad.tolist(), st_any.tolist()
    fget = fcache.get
    for r in range(nrec):
        if bad_l[r]:
            fallback.append(metas[r][0])
            continue
        fk = fkey_bytes[r * FW:(r + 1) * FW]
        formula = fget(fk)
        if formula is None:
            formula = fcache[fk] = build_formula(fk)
        # the -1s drop each layer's trailing comma (empty layers guarded)
        c0_, c1_ = conn_b[r], conn_b[r + 1]
        h0_, h1_ = hs_b[r], hs_b[r + 1]
        sid = (
            "InChI=1S/" + formula
            + "/e" + el_s[el_b[r]:el_b[r + 1]].decode()
            + "/c" + (conn_s[c0_:c1_ - 1].decode() if c1_ > c0_ else "")
            + "/h" + (hs_s[h0_:h1_ - 1].decode() if h1_ > h0_ else "")
        )
        if st_l[r]:
            sid += "/t" + st_s[st_b[r]:st_b[r + 1] - 1].decode()
        ids[metas[r][0]] = sid


# ---------------------------------------------------------------------------
# Digest compare (the hash_mix device batch)
# ---------------------------------------------------------------------------

def _bucket(n: int, lo: int = 32) -> int:
    b = lo
    while b < n:
        b <<= 1
    return b


def compare_ids_batch(
    expected: Sequence[str],
    recomputed: Sequence[str],
    backend: str = "auto",
    device: DeviceLike = "cuda",
) -> List[bool]:
    """Per-record verification compare, vectorized.

    ``backend="digest"`` packs both id columns into uint32 lanes and runs
    ONE :func:`repro_torch.kernels.hash_mix.ops.hash_mix` batch over them
    on ``device`` (the CUDA kernel on the card, its plain PyTorch version
    on the CPU; shapes are bucketed as in the reference package), accepting
    records whose 128-bit digests agree and falling back to a full-string
    compare only on digest disagreement — digest inequality already proves
    string inequality, so the fallback can only confirm the mismatch.
    ``backend="string"`` compares strings directly.  ``"auto"`` means
    ``"digest"`` on a CUDA device and ``"string"`` on the CPU, where the
    C-speed string compare beats the plain PyTorch digest.
    """
    device = resolve_device(device)
    if backend == "auto":
        backend = "digest" if device.type == "cuda" else "string"
    if backend == "string":
        return [e == r for e, r in zip(expected, recomputed)]
    if backend != "digest":
        raise ValueError(f"unknown verify backend {backend!r}")
    n = len(expected)
    if n == 0:
        return []
    ids = list(expected) + list(recomputed)
    lanes = _bucket(lanes_for(ids), lo=32)
    m = _bucket(2 * n, lo=64)
    ids += [""] * (m - 2 * n)
    packed = torch.from_numpy(pack_ids(ids, lanes)).to(device)
    digests = hash_mix(packed).cpu().numpy()
    same = (digests[:n] == digests[n : 2 * n]).all(axis=1)
    # Digest-equal => verified (a 128-bit expected/recomputed collision is
    # negligible); digest-unequal => full-string compare, which documents
    # the mismatch the digests already proved.
    return [bool(s) or expected[i] == recomputed[i] for i, s in enumerate(same)]


# ---------------------------------------------------------------------------
# Cross-worker batching
# ---------------------------------------------------------------------------

_PROC_POOL = None
_PROC_LOCK = threading.Lock()


def _recompute_chunk(items: List) -> List[str]:
    """Process-pool unit: vectorized recompute in a child process."""
    return recompute_ids_batch(items)


def _process_pool():
    global _PROC_POOL
    with _PROC_LOCK:
        if _PROC_POOL is None:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            try:
                ctx = multiprocessing.get_context("fork")
            except ValueError:  # pragma: no cover - non-posix
                ctx = None
            _PROC_POOL = ProcessPoolExecutor(
                max_workers=max(1, (os.cpu_count() or 2) - 1),
                mp_context=ctx,
            )
            atexit.register(_PROC_POOL.shutdown)
    return _PROC_POOL


class _Chunk:
    __slots__ = ("expected", "payloads", "pre", "stats", "event", "ok",
                 "ids", "error")

    def __init__(self, expected, payloads, pre, stats):
        self.expected = expected
        self.payloads = payloads
        self.pre = pre
        self.stats = stats
        self.event = threading.Event()
        self.ok: Optional[List[bool]] = None
        self.ids: Optional[List[str]] = None
        self.error: Optional[BaseException] = None


class VerifyBatcher:
    """Combine verification work across workers into one batched pass.

    Workers call :meth:`verify`; whoever arrives while no leader is
    active becomes the leader and drains the queue — its combined batch
    covers every worker that enqueued meanwhile (continuous batching,
    the same shape as the service's ``MicroBatcher``, but synchronous:
    the caller needs the answer before it can emit events).  A service
    shares ONE batcher across every concurrent ``fetch``, so the device
    digest pass (or the process pool) sees cross-request batches.

    ``device`` (default ``"cuda"``) is where the digest compare runs:
    ``"auto"`` rides the ``hash_mix`` kernel on a CUDA verifier and the
    string compare on a CPU one.
    """

    def __init__(
        self,
        backend: str = "auto",
        combine: bool = True,
        device: DeviceLike = "cuda",
    ):
        if backend not in ("auto", "string", "digest", "vector", "process"):
            raise ValueError(f"unknown verify backend {backend!r}")
        self.device = resolve_device(device)
        self.backend = backend
        self.combine = combine and backend not in ("string", "digest")
        self._lock = threading.Lock()
        self._queue: List[_Chunk] = []
        self._leading = False

    # -- public --------------------------------------------------------------

    def verify(
        self,
        expected: Sequence[str],
        payloads: Sequence,
        precomputed: Optional[Sequence[Optional[str]]] = None,
        stats=None,
    ) -> Tuple[List[bool], List[str]]:
        """``(ok, recomputed_ids)`` for one worker's records.

        ``precomputed`` carries ids already known (warm cache hits) —
        those records skip the recompute but still ride the combined
        compare, exactly like the legacy per-worker path did.
        """
        n = len(expected)
        if n == 0:
            return [], []
        pre = list(precomputed) if precomputed is not None else [None] * n

        if self.backend in ("string", "digest"):
            # reference per-record recompute (the ablation/legacy path)
            ids = [
                pre[i] if pre[i] is not None
                else _recompute(_payload_text(payloads[i]))
                for i in range(n)
            ]
            ok = compare_ids_batch(expected, ids, self.backend, self.device)
            if stats is not None:
                stats.verify_batches += 1
                stats.verify_records += n
                stats.verify_batch_max = max(stats.verify_batch_max, n)
            return ok, ids

        chunk = _Chunk(list(expected), list(payloads), pre, stats)
        if not self.combine:
            self._run_batch([chunk])
            if chunk.error is not None:
                raise chunk.error
            return chunk.ok, chunk.ids

        with self._lock:
            self._queue.append(chunk)
            lead = not self._leading
            if lead:
                self._leading = True
        if not lead:
            chunk.event.wait()
            if chunk.error is not None:
                raise chunk.error
            return chunk.ok, chunk.ids
        try:
            while True:
                with self._lock:
                    batch, self._queue = self._queue, []
                    if not batch:
                        self._leading = False
                        break
                self._run_batch(batch)
        except BaseException:
            with self._lock:  # pragma: no cover - defensive
                self._leading = False
            raise
        if chunk.error is not None:
            raise chunk.error
        return chunk.ok, chunk.ids

    # -- internals -----------------------------------------------------------

    def _run_batch(self, batch: List[_Chunk]) -> None:
        try:
            need = []
            slots = []
            total = 0
            for c in batch:
                total += len(c.expected)
                for k, rid in enumerate(c.pre):
                    if rid is None:
                        need.append(c.payloads[k])
                        slots.append((c, k))
            ids_need = self._recompute_many(need)
            for (c, k), rid in zip(slots, ids_need):
                c.pre[k] = rid
            # one combined compare across every chunk (on a CUDA verifier
            # this is the single hash_mix digest pass for all workers)
            exp_all: List[str] = []
            ids_all: List[str] = []
            for c in batch:
                exp_all.extend(c.expected)
                ids_all.extend(c.pre)  # type: ignore[arg-type]
            ok_all = compare_ids_batch(exp_all, ids_all, "auto", self.device)
            pos = 0
            for c in batch:
                m = len(c.expected)
                c.ok = ok_all[pos:pos + m]
                c.ids = c.pre  # type: ignore[assignment]
                pos += m
                if c.stats is not None:
                    c.stats.verify_records += m
                    c.stats.verify_batch_max = max(
                        c.stats.verify_batch_max, total
                    )
            lead_stats = batch[0].stats
            if lead_stats is not None:
                lead_stats.verify_batches += 1  # one physical batch
        except BaseException as e:
            for c in batch:
                c.error = e
        finally:
            for c in batch:
                c.event.set()

    def _recompute_many(self, payloads: List) -> List[str]:
        if not payloads:
            return []
        if self.backend == "process" and len(payloads) >= 2:
            pool = _process_pool()
            workers = pool._max_workers
            # serialize views to bytes for the children (the one copy
            # this mode pays); strings pass through
            items = [
                p if isinstance(p, str)
                else (bytes(p.mem()) if isinstance(p, RecordView)
                      else bytes(p))
                for p in payloads
            ]
            step = max(64, (len(items) + workers - 1) // workers)
            chunks = [items[i:i + step] for i in range(0, len(items), step)]
            out: List[str] = []
            for part in pool.map(_recompute_chunk, chunks):
                out.extend(part)
            return out
        return recompute_ids_batch(payloads)
