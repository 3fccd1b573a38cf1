"""CUDA wrapper for ``sorted_probe`` (source:
``src/repro_torch/csrc/sorted_probe.cu``), and :class:`ProbeTable`, a
sorted table with its fences.

Replaces the Pallas kernel ``probe_blocks_pallas`` / ``_probe_kernel`` of
``src/repro/kernels/sorted_probe/kernel.py`` and its stages A and C
(``sorted_probe_pallas`` and ``_fence_assign`` in ``ops.py``).  Both
routes return the global lower bound (the head of a duplicate run) and
the found flag, bit-exact with ``sorted_probe_ref``.  :func:`route` picks
one per table, from its rows and alignment alone (never after a failure):

* ``"direct"`` (fewer than ``FENCED_MIN_ROWS`` rows, or a base off
  16-byte alignment): one thread per query, a branch-free lower-bound
  search over the whole table, ~log2(M) dependent 8-byte loads.
* ``"fenced"``: the reference's fences (``ops.py`` ``fences =
  t_pad[::bt]``) as a static search tree over the table's lines of
  ``NODE_KEYS`` keys, built once per table that takes this route, by
  :class:`ProbeTable` (:func:`build_fences`; an eighth of the table).  A
  group of ``NODE_KEYS / 2`` lanes reads one node a level with 16-byte
  loads and counts the keys below the query by ballot; the leaf is one
  line of the table.  Past the card's 50 MB L2 the direct search pays ~5.5 dependent
  DRAM round trips a query after ~20 dependent L2 hits; the fenced one two
  random line reads from DRAM (a level-1 node, a leaf) after L2 and L1
  hits, so it is bound by the rate of those line reads.

A direct-route table has no fences; a plain CUDA tensor takes the direct
route (fences built per call would read the whole table each time).  The
store keeps every device table as a :class:`ProbeTable`, whose one check
at construction lets the served call skip the table's checks: it checks
the queries, allocates the two outputs (one allocation cut into two views
cost the host more: PERF.md), enters ``torch.cuda.device`` only off the current device, and
launches through the cached C function on the current stream's raw handle.

``sorted_probe_cuda.launches`` counts the launches of either kernel,
``direct_launches`` and ``fenced_launches`` those of each route, and
``fence_builds`` the fence builds (thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..build import count_launch, load

__all__ = [
    "FENCED_MIN_ROWS", "NODE_KEYS", "ProbeTable", "ROUTES", "build_fences",
    "fence_levels", "launch", "probe_served", "route", "sorted_probe_cuda",
]

ROUTES = ("direct", "fenced")
# keys a fence node and a leaf line hold, as csrc/sorted_probe.cu's
# kNodeKeys (the card measured 16-key nodes slower at PubChem's probe:
# PERF.md, scripts/probe_grid.py --variants nodes16)
NODE_KEYS = 8
# the least rows the fenced route takes: from 2^17 rows it beat the direct
# search at every Q of scripts/probe_grid.py --grid (32 to 477,123); below,
# the direct search wins once Q passes ~67,584 (PERF.md row 2b)
FENCED_MIN_ROWS = 1 << 17
FENCED_ALIGN = 16  # bytes: the fenced kernel reads 16-byte pieces
_PAD = -1  # an all-ones (hi, lo) pair in int32 view: never below a query

_FNS = {}
_PTR, _LL = ctypes.c_void_p, ctypes.c_longlong
_ARGTYPES = {  # the C functions of csrc/sorted_probe.cu
    "sorted_probe_launch": [_PTR, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _PTR],
    "sorted_probe_served": [_PTR, _PTR, _PTR, _PTR, _PTR, _LL, _LL, _PTR],
}


def _fn(name: str):
    f = _FNS.get(name)
    if f is None:
        f = getattr(load("sorted_probe"), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _FNS[name] = f
    return f


def route(m: int, data_ptr: int) -> str:
    """``"direct"`` or ``"fenced"``: which kernel searches a table of ``m``
    rows starting at address ``data_ptr``."""
    if m >= FENCED_MIN_ROWS and data_ptr % FENCED_ALIGN == 0:
        return "fenced"
    return "direct"


def fence_levels(m: int) -> Tuple[List[Tuple[int, int]], int]:
    """The fences of an ``m``-row table cut into leaf lines of ``NODE_KEYS``
    (B) keys: ``([(offset, nodes), ...], total)``, level 1 first, up to a
    level of one node.  A node holds B keys and has B + 1 children (slot k
    is the first key of child k + 1; child 0's first key is implied), so a
    level has ceil(children / (B + 1)) nodes; it starts ``offset`` keys into
    the fence array, ``total`` keys long.  ``csrc/sorted_probe.cu``
    ``launch_fenced`` computes the same offsets."""
    b = NODE_KEYS
    levels = []
    n, at = -(-m // b), 0  # leaf lines
    while n > 1:
        n = -(-n // (b + 1))
        levels.append((at, n))
        at += n * b
    return levels, at


def build_fences(table: torch.Tensor) -> torch.Tensor:
    """``(total, 2)`` uint32 fences of sorted ``table`` on its device, a
    static search tree of ``NODE_KEYS``-key nodes over its lines: strided
    copies, one a level, pads all ones.  Counted in
    ``sorted_probe_cuda.fence_builds``."""
    b = NODE_KEYS
    levels, total = fence_levels(table.shape[0])
    fences = torch.empty((total, 2), dtype=torch.uint32, device=table.device)
    words = fences.view(torch.int32)  # uint32 copies and fills go through int32
    firsts = table.view(torch.int32)[::b]  # the first key of each leaf line
    for off, n in levels:
        # child t of node j is t = j (B + 1) + k + 1 for slot k: the children's
        # first keys, padded to whole nodes, as (nodes, B + 1) rows, less column 0
        kids = torch.full((n * (b + 1), 2), _PAD, dtype=torch.int32,
                          device=table.device)
        kids[:firsts.shape[0]] = firsts
        words[off:off + n * b].view(n, b, 2).copy_(kids.view(n, b + 1, 2)[:, 1:])
        firsts = kids[::b + 1]  # the first key of each node of this level
    count_launch(sorted_probe_cuda, "fence_builds")
    return fences


def _check_pairs(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.uint32 or t.ndim != 2 or t.shape[1] != 2:
        raise TypeError(
            f"{name} must be (N, 2) uint32, got {tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class ProbeTable:
    """A sorted ``(M, 2)`` uint32 table, checked once, with its route and,
    on the fenced route, its fences.

    The route is fixed here (:func:`route`), and the fences are built here,
    once, on the table's device, when the route is ``"fenced"`` (on any
    device: the plain version ignores them); a direct-route table has
    none.  ``fences=`` adopts fences already built for this table (a copy
    from another device, or a tool that forces the fenced kernel on a
    direct-route table).  ``nbytes`` is the table's bytes and the fences'.
    """

    __slots__ = ("table", "fences", "m", "route", "device", "_index",
                 "_table_ptr", "_fences_ptr")

    def __init__(self, table: torch.Tensor, fences: Optional[torch.Tensor] = None):
        _check_pairs("table", table)
        m = table.shape[0]
        if m >= 2**31:
            raise ValueError(f"table of {m} rows overflows the int32 positions")
        self.route = route(m, table.data_ptr())
        if fences is None and self.route == "fenced":
            fences = build_fences(table)
        elif fences is not None and (fences.device != table.device
                                     or fences.shape != (fence_levels(m)[1], 2)):
            raise ValueError("fences do not belong to this table")
        self.table = table
        self.fences = fences
        self.m = m
        self.device = table.device
        self._index = table.get_device()  # -1 on the CPU
        # what a launch on this table's route passes (0: the direct route)
        self._table_ptr = table.data_ptr()
        self._fences_ptr = fences.data_ptr() if self.route == "fenced" else 0

    @property
    def fence_bytes(self) -> int:
        return 0 if self.fences is None else self.fences.numel() * 4

    @property
    def nbytes(self) -> int:
        return self.table.numel() * 4 + self.fence_bytes

    def to(self, device) -> "ProbeTable":
        """A copy on ``device``, its fences copied, not built again."""
        fences = None if self.fences is None else self.fences.to(device)
        return ProbeTable(self.table.to(device), fences=fences)


def launch(path: str, pt: ProbeTable, queries: torch.Tensor,
           pos: torch.Tensor, found: torch.Tensor) -> None:
    """Launch route ``path``'s kernel over ``pt`` (``"fenced"`` needs its
    fences) on checked CUDA ``queries`` into ``pos`` (int32) and ``found``
    (bool), on the current device.  Raises if the launch fails."""
    if path == "fenced" and pt.fences is None:
        raise ValueError("the fenced kernel needs a table with fences")
    fences = pt.fences.data_ptr() if path == "fenced" else 0
    _launch(path, pt._table_ptr, fences, pt.m, queries, pos, found)


def _launch(path: str, table: int, fences: int, m: int, queries: torch.Tensor,
            pos: torch.Tensor, found: torch.Tensor) -> None:
    # the raw handle of the current stream (what torch.cuda.current_stream()
    # .cuda_stream returns, without building a Stream object)
    stream = torch._C._cuda_getCurrentRawStream(queries.get_device())
    err = _fn("sorted_probe_launch")(
        queries.data_ptr(), table, fences, pos.data_ptr(), found.data_ptr(),
        queries.shape[0], m, stream)
    if err != 0:
        raise RuntimeError(f"sorted_probe {path} kernel launch failed: cudaError {err}")
    count_launch(sorted_probe_cuda, "launches", f"{path}_launches")


def _check_queries(queries: torch.Tensor) -> None:
    if (queries.dtype != torch.uint32 or queries.ndim != 2
            or queries.shape[1] != 2 or not queries.is_contiguous()):
        raise TypeError(
            "queries must be contiguous (Q, 2) uint32, got "
            f"{tuple(queries.shape)} {queries.dtype}"
        )


def sorted_probe_cuda(
    queries: torch.Tensor, table
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(found (Q,) bool, pos (Q,) int32)`` of ``queries`` in sorted
    ``table``: a :class:`ProbeTable` (its route) or a plain ``(M, 2)``
    uint32 tensor (checked on every call; the direct route)."""
    if isinstance(table, ProbeTable):
        index, path = table._index, table.route
    else:
        if table.device.type != "cuda":
            index = -1
        else:
            _check_pairs("table", table)
            if table.shape[0] >= 2**31:
                raise ValueError(
                    f"table of {table.shape[0]} rows overflows the int32 positions")
            index = table.get_device()
        path = "direct"
    if index < 0 or queries.get_device() != index:
        raise ValueError(
            "sorted_probe_cuda needs queries and table on one CUDA device, "
            f"got {queries.device} and {table.device}"
        )
    _check_queries(queries)
    q = queries.shape[0]
    pos = torch.empty(q, dtype=torch.int32, device=queries.device)
    found = torch.empty(q, dtype=torch.bool, device=queries.device)
    if isinstance(table, ProbeTable):
        tptr, fptr, m = table._table_ptr, table._fences_ptr, table.m
    else:
        tptr, fptr, m = table.data_ptr(), 0, table.shape[0]
    if q == 0:
        return found, pos
    if m == 0:
        return found.zero_(), pos.zero_()
    if index == torch._C._cuda_getDevice():
        _launch(path, tptr, fptr, m, queries, pos, found)
    else:
        with torch.cuda.device(index):
            _launch(path, tptr, fptr, m, queries, pos, found)
    return found, pos


def probe_served(pt: ProbeTable, host_queries: torch.Tensor,
                 host_out: torch.Tensor, q: int) -> None:
    """The store's served probe: the first ``q`` queries of pinned
    ``host_queries`` (``(N, 2)`` uint32) against CUDA table ``pt``, ``q``
    int32 positions then ``q`` found flags into pinned ``host_out`` (at
    least ``5 q`` bytes), done when this returns.  One device allocation
    (queries and both outputs), then one C call: the copy in, ``pt``'s
    route, the copy out, a wait on the current stream."""
    if pt._index < 0:
        raise ValueError(f"probe_served needs a CUDA table, got {pt.device}")
    if host_queries.shape[0] < q or host_out.numel() < 5 * q:
        raise ValueError(f"host buffers too small for {q} queries")
    if q == 0:
        return
    if pt.m == 0:
        host_out[:5 * q].zero_()
        return
    if pt._index != torch._C._cuda_getDevice():
        with torch.cuda.device(pt._index):
            return probe_served(pt, host_queries, host_out, q)
    buf = torch.empty(13 * q, dtype=torch.uint8, device=pt.device)
    err = _fn("sorted_probe_served")(
        host_queries.data_ptr(), buf.data_ptr(), pt._table_ptr, pt._fences_ptr,
        host_out.data_ptr(), q, pt.m, torch._C._cuda_getCurrentRawStream(pt._index))
    if err != 0:
        raise RuntimeError(f"sorted_probe {pt.route} served probe failed: cudaError {err}")
    count_launch(sorted_probe_cuda, "launches", f"{pt.route}_launches")


sorted_probe_cuda.launches = 0
sorted_probe_cuda.direct_launches = 0
sorted_probe_cuda.fenced_launches = 0
sorted_probe_cuda.fence_builds = 0
