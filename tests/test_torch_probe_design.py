"""The design of the port's ``sorted_probe`` and ``hash_mix`` kernels, on
the CPU.

``sorted_probe`` has two kernels.  The direct route runs one branch-free
lower-bound search per query (``half = len >> 1``, ``len -= half``, move
``base`` by ``half`` when ``table[base + half - 1] < key``).  The fenced
route walks the table's fences (``build_fences``: a static search tree
over the table's lines of B = 8 keys, each node B keys that separate B + 1
children, padded with all-ones keys) from the top: a group of B/2 lanes
reads one node (two keys a lane), counts the keys strictly below the
query by ballot, takes that child, and ends on one line of the table,
keys at or past M masked; the first key not below the query, shuffled
out of a node or inherited from the level above, gives the found flag.
Python twins of both searches, replayed here on tables with runs of equal
keys (runs that fill whole lines and straddle lines and fences), must give
``sorted_probe_ref``'s answer and ``repro``'s: the head of a run, the
found flag, and the positions past either end.  The route is a pure
function of rows and alignment, as is ``hash_mix``'s, only a fenced-route
table builds fences, and a CPU tensor takes the plain version and
launches nothing.
"""

import numpy as np
import pytest
import torch

from repro.kernels.sorted_probe.ref import sorted_probe_ref as r_sorted_probe_ref
from repro_torch.kernels.hash_mix.kernel import STAGED_WIDTHS, hash_mix_cuda
from repro_torch.kernels.hash_mix.kernel import route as hash_route
from repro_torch.kernels.hash_mix.ops import hash_mix
from repro_torch.kernels.hash_mix.ref import hash_mix_ref
from repro_torch.kernels.sorted_probe import kernel as probe_kernel
from repro_torch.kernels.sorted_probe.kernel import (
    FENCED_MIN_ROWS,
    NODE_KEYS,
    ProbeTable,
    build_fences,
    fence_levels,
    sorted_probe_cuda,
)
from repro_torch.kernels.sorted_probe.ops import sorted_probe
from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

TABLE_SIZES = [1, 2, 3, 2**13 - 1, 2**13, 2**13 + 1, 100_003]


def _branch_free_search(table: np.ndarray, keys: np.ndarray):
    """The kernel's search over uint64 ``table``: ``(found, pos)``."""
    m = table.size
    base = np.zeros(keys.size, dtype=np.int64)
    length = m
    while length > 1:
        half = length >> 1
        base = np.where(table[base + half - 1] < keys, base + half, base)
        length -= half
    pos = base + (table[base] < keys)
    found = (pos < m) & (table[np.minimum(pos, m - 1)] == keys)
    return found, pos


def _table_and_queries(m: int, seed: int):
    """A sorted uint64 table of ``m`` keys with runs of equal keys, and
    queries: every run's key, its neighbours, the table's extremes and
    beyond, and random keys."""
    rng = np.random.default_rng(seed)
    table = np.sort(rng.integers(0, 2**64, m, dtype=np.uint64))
    for p in rng.integers(0, m, min(m, 128)):
        lo, hi = max(0, p - 3), min(m, p + 4)
        table[lo:hi] = table[lo]
    table = np.sort(table)
    picks = table[rng.integers(0, m, 500)]
    queries = np.concatenate([
        picks, picks + np.uint64(1), picks - np.uint64(1),
        np.array([0, 2**64 - 1, table[0], table[-1]], dtype=np.uint64),
        rng.integers(0, 2**64, 200, dtype=np.uint64),
    ])
    return table, queries


def _pairs(keys: np.ndarray) -> np.ndarray:
    return np.stack([(keys >> np.uint64(32)).astype(np.uint32),
                     (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)], axis=1)


@pytest.mark.parametrize("m", TABLE_SIZES)
def test_branch_free_search_gives_the_references_answer(m):
    """The kernel's search, replayed in Python, against ``sorted_probe_ref``
    (which a CPU tensor runs through ``sorted_probe``) and ``repro``'s
    reference, on a table with runs of equal keys."""
    table, queries = _table_and_queries(m, seed=m)
    found, pos = _branch_free_search(table, queries)
    tq, tt = torch.from_numpy(_pairs(queries)), torch.from_numpy(_pairs(table))
    f_ref, p_ref = sorted_probe_ref(tq, tt)
    np.testing.assert_array_equal(pos, p_ref.numpy())
    np.testing.assert_array_equal(found, f_ref.numpy())
    f_op, p_op = sorted_probe(tq, tt)
    assert torch.equal(f_op, f_ref) and torch.equal(p_op, p_ref)
    f_r, p_r = r_sorted_probe_ref(_pairs(queries), _pairs(table))
    np.testing.assert_array_equal(pos, np.asarray(p_r))
    np.testing.assert_array_equal(found, np.asarray(f_r))
    # a run is entered at its head
    heads = pos[found & (pos > 0)]
    assert (table[heads - 1] < table[heads]).all()


FENCED_SIZES = [1, 2, 15, 16, 17, 255, 256, 257, 4_097, 65_537]
ALL_ONES = np.uint64(2**64 - 1)


def _u64(pairs: torch.Tensor) -> np.ndarray:
    """``(N, 2)`` uint32 ``(hi, lo)`` → uint64 keys."""
    v = pairs.numpy().astype(np.uint64)
    return (v[:, 0] << np.uint64(32)) | v[:, 1]


def _group_read(block: np.ndarray, keys: np.ndarray, succ: np.ndarray):
    """One node read by a group of B/2 lanes, two keys a lane: the count of
    keys below each query (two ballots, masked to the group, popcounts), and
    ``succ`` updated with the first key not below it (a shuffle from lane
    ``min(cnt >> 1, B/2 - 1)``, element ``cnt & 1``) when the node holds one."""
    q, b = block.shape
    lanes = block.reshape(q, b // 2, 2)
    b0 = lanes[:, :, 0] < keys[:, None]
    b1 = lanes[:, :, 1] < keys[:, None]
    cnt = b0.sum(1) + b1.sum(1)
    src = np.minimum(cnt >> 1, b // 2 - 1)
    at = lanes[np.arange(q), src, cnt & 1]
    return cnt, np.where(cnt < b, at, succ)


def _fenced_search(table: np.ndarray, fences: np.ndarray, keys: np.ndarray):
    """The fenced kernel's search over uint64 ``table`` with its uint64
    ``fences`` in nodes of ``NODE_KEYS`` keys: ``(found, pos)``."""
    m, b = table.size, NODE_KEYS
    levels, total = fence_levels(m)
    assert fences.size == total
    q = keys.size
    node = np.zeros(q, dtype=np.int64)
    succ = np.zeros(q, dtype=np.uint64)
    for off, n in reversed(levels):
        assert (node < n).all()  # the node lies inside its level
        cnt, succ = _group_read(fences[off + node[:, None] * b + np.arange(b)],
                                keys, succ)
        node = node * (b + 1) + cnt  # child cnt of b + 1
    assert (node * b < max(m, 1)).all()  # pads never lead past the last line
    idx = node[:, None] * b + np.arange(b)
    leaf = np.where(idx < m, table[np.minimum(idx, m - 1)], ALL_ONES)
    cnt, succ = _group_read(leaf, keys, succ)
    pos = node * b + cnt
    return (pos < m) & (succ == keys), pos


def _runs_table(m: int, seed: int) -> np.ndarray:
    """A sorted 24-bit table of ``m`` keys whose duplicate runs fill whole
    lines (B keys from a line's start, and (B + 1) B: a level-1 node's
    children) and straddle lines and fences (B + 1 keys from one before a
    line, 2 B + 3 across a level-1 separator), plus random short runs."""
    b = NODE_KEYS
    rng = np.random.default_rng(seed)
    table = np.sort(rng.integers(0, 1 << 24, m, dtype=np.uint64))
    for start, length in ((b, b), (3 * b - 1, b + 1), (b * (b + 1) - b - 1, 2 * b + 3),
                          (2 * b * (b + 1), b * (b + 1)), (5 * b + 3, 7)):
        if start < m:
            table[start:start + length] = table[start]
    for p in rng.integers(0, m, min(m, 64)):
        table[p:p + 5] = table[p]
    assert (np.diff(table.astype(np.int64)) >= 0).all()
    return table


def _queries_for(table: np.ndarray, seed: int) -> np.ndarray:
    """Every run's key and its neighbours, keys below the first and above
    the last, both ends of the key space, random keys."""
    rng = np.random.default_rng(seed)
    m = table.size
    picks = np.unique(table)
    picks = picks[rng.permutation(picks.size)[:600]]
    lo, hi = table[0], table[-1]
    ends = [0, 2**64 - 1, lo, hi, hi + np.uint64(1), 2**32, 2**32 - 1]
    if lo > 0:
        ends.append(lo - np.uint64(1))
    return np.concatenate([
        picks, picks + np.uint64(1), picks - np.uint64(1),
        np.array(ends, dtype=np.uint64),
        table[rng.integers(0, m, 100)],
        rng.integers(0, 2**64, 100, dtype=np.uint64),
        rng.integers(0, 1 << 25, 100, dtype=np.uint64),
    ])


def _separators(table: np.ndarray):
    """Each level's node keys as the tree defines them: slot k of node j is
    the first key of child j (b + 1) + k + 1, all ones past the last."""
    b = NODE_KEYS
    lines = -(-table.size // b)
    firsts = table[::b]  # first key of each child, level 0: the lines
    out = []
    for _, n in fence_levels(table.size)[0]:
        t = np.arange(n)[:, None] * (b + 1) + np.arange(1, b + 1)
        out.append(np.where(t < firsts.size, firsts[np.minimum(t, firsts.size - 1)],
                            ALL_ONES).ravel())
        firsts = firsts[::b + 1]
    assert lines >= 1
    return out


def _check_fenced(table: np.ndarray, queries: np.ndarray):
    """The fences ``build_fences`` makes (those a fenced-route table builds,
    here built for tables of any size), the replay over them, and the
    entry point on a CPU ``ProbeTable`` that holds them."""
    b = NODE_KEYS
    tt, tq = torch.from_numpy(_pairs(table)), torch.from_numpy(_pairs(queries))
    builds = sorted_probe_cuda.fence_builds
    pt = ProbeTable(tt, fences=build_fences(tt))
    assert sorted_probe_cuda.fence_builds == builds + 1
    fences = _u64(pt.fences)
    levels, _ = fence_levels(table.size)
    for (off, n), want in zip(levels, _separators(table)):
        np.testing.assert_array_equal(fences[off:off + n * b], want)
    found, pos = _fenced_search(table, fences, queries)
    f_ref, p_ref = sorted_probe_ref(tq, tt)
    np.testing.assert_array_equal(pos, p_ref.numpy())
    np.testing.assert_array_equal(found, f_ref.numpy())
    f_r, p_r = r_sorted_probe_ref(_pairs(queries), _pairs(table))
    np.testing.assert_array_equal(pos, np.asarray(p_r))
    np.testing.assert_array_equal(found, np.asarray(f_r))
    # the entry point on a CPU ProbeTable: the plain version, no launch
    launches = sorted_probe_cuda.launches
    f_op, p_op = sorted_probe(tq, pt)
    assert torch.equal(f_op, f_ref) and torch.equal(p_op, p_ref)
    assert sorted_probe_cuda.launches == launches
    heads = pos[found & (pos > 0)]
    assert (table[heads - 1] < table[heads]).all()
    return found


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", FENCED_SIZES)
def test_fenced_search_gives_the_references_answer(m, seed):
    """The fenced kernel's search, replayed in Python over the fences that
    ``build_fences`` makes, against ``sorted_probe_ref`` and ``repro``'s
    reference: 64-bit keys with runs of equal keys, two draws a size."""
    table, queries = _table_and_queries(m, seed=m + 16 * seed)
    found = _check_fenced(table, queries)
    assert found.any()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [17, 257, 4_097, 65_537])
def test_fenced_search_on_duplicate_runs(m, seed):
    """24-bit tables whose runs fill whole lines and straddle lines and
    fences: the answer is still the head of the run (two draws of the
    random short runs a size)."""
    table = _runs_table(m, seed=m + seed)
    queries = _queries_for(table, seed=m + 1)
    found = _check_fenced(table, queries)
    assert found.any() and not found.all()


@pytest.mark.parametrize("m", [300, FENCED_MIN_ROWS])
def test_fenced_search_with_no_queries(m):
    """Q = 0 on a small table given its fences, and on one at the fenced
    route's line, which builds its own."""
    table = _runs_table(m, seed=3)
    tt = torch.from_numpy(_pairs(table)).clone()  # torch's 64-byte alignment
    pt = ProbeTable(tt) if m >= FENCED_MIN_ROWS else ProbeTable(tt, fences=build_fences(tt))
    assert pt.route == ("fenced" if m >= FENCED_MIN_ROWS else "direct")
    empty = np.zeros(0, dtype=np.uint64)
    found, pos = _fenced_search(table, _u64(pt.fences), empty)
    assert found.shape == pos.shape == (0,)
    f, p = sorted_probe(torch.from_numpy(_pairs(empty)), pt)
    assert f.shape == p.shape == (0,) and f.dtype == torch.bool and p.dtype == torch.int32


def test_fence_levels_at_the_papers_scale():
    """PubChem's 176,929,690 rows: nodes of 8 keys give 22,116,212 lines
    under eight levels, an eighth of the table (under a seventh)."""
    m = 176_929_690
    levels, total = fence_levels(m)
    assert [n for _, n in levels] == [2_457_357, 273_040, 30_338, 3_371, 375, 42, 5, 1]
    assert total == 8 * sum(n for _, n in levels) and total * 8 < m * 8 / 7
    assert all(off % 8 == 0 for off, _ in levels)
    assert fence_levels(8) == ([], 0) and fence_levels(9) == ([(0, 1)], 8)
    assert fence_levels(73) == ([(0, 2), (16, 1)], 24)  # 10 lines: 2 nodes, a root


@pytest.mark.parametrize("m,ptr,want", [
    (100_000, 0x7F0000000000, "direct"),            # a served plane
    (11_058_106, 0x7F0000000000, "fenced"),         # a PubChem shard
    (176_929_690, 0x7F0000000200, "fenced"),        # PubChem's plane
    (176_929_690, 0x7F0000000008, "direct"),        # off 16-byte alignment
    (probe_kernel.FENCED_MIN_ROWS - 1, 0x7F0000000000, "direct"),
    (probe_kernel.FENCED_MIN_ROWS, 0x7F0000000000, "fenced"),
    (8_388_608, 0x7F0000000000, "fenced"),          # 64 MB, past L2
])
def test_sorted_probe_route_is_a_function_of_rows_and_alignment(m, ptr, want):
    assert probe_kernel.route(m, ptr) == want


def test_probe_table_checks_once_and_copies_its_fences():
    """``ProbeTable`` refuses what the kernels do not take, builds fences
    only on the fenced route (once), adopts fences it is given, and ``to``
    copies them without building them again."""
    rng = np.random.default_rng(0)
    t = torch.from_numpy(_pairs(np.sort(rng.integers(0, 2**64, 1000, dtype=np.uint64))))
    with pytest.raises(TypeError):
        ProbeTable(t.view(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        ProbeTable(t.t().contiguous().t())
    builds = sorted_probe_cuda.fence_builds
    direct = ProbeTable(t)  # under the fenced route's line: no fences
    assert direct.route == "direct" and direct.fences is None
    assert direct.fence_bytes == 0 and direct.nbytes == 1000 * 8
    assert direct.to("cpu").fences is None
    assert sorted_probe_cuda.fence_builds == builds
    with pytest.raises(ValueError, match="fences"):  # before any CUDA call
        probe_kernel.launch("fenced", direct, t, t, t)
    pt = ProbeTable(t, fences=build_fences(t))
    copy = pt.to("cpu")
    assert sorted_probe_cuda.fence_builds == builds + 1
    assert torch.equal(copy.fences, pt.fences)
    # 125 lines of 8 under 14 nodes, 2 above them, then a root: 17 nodes
    assert pt.nbytes == 1000 * 8 + pt.fence_bytes and pt.fence_bytes == 17 * 8 * 8
    with pytest.raises(ValueError, match="belong"):
        ProbeTable(t[:200], fences=pt.fences)
    big = torch.from_numpy(_pairs(np.sort(rng.integers(
        0, 2**64, FENCED_MIN_ROWS, dtype=np.uint64)))).clone()
    fenced = ProbeTable(big)  # at the line: the route builds its own, once
    assert fenced.route == "fenced" and sorted_probe_cuda.fence_builds == builds + 2
    assert torch.equal(fenced.fences, build_fences(big))
    assert fenced.nbytes == big.numel() * 4 + fenced.fence_bytes


@pytest.mark.parametrize("w,ptr,want", [
    (32, 0x7F0000000000, "staged"),
    (64, 0x7F0000000010, "staged"),
    (128, 0x7F0000001000, "staged"),
    (256, 0x7F0000000030, "staged"),
    (128, 0x7F0000000004, "rowwise"),   # x[1:] of a flat buffer
    (128, 0x7F0000000008, "rowwise"),
    (512, 0x7F0000000000, "rowwise"),   # beyond the templated widths
    (48, 0x7F0000000000, "rowwise"),    # a multiple of 16 bytes, not templated
    (1, 0x7F0000000000, "rowwise"),
    (33, 0x7F0000000000, "rowwise"),
])
def test_hash_mix_route_is_a_function_of_width_and_alignment(w, ptr, want):
    assert hash_route(w, ptr) == want


def test_staged_widths_are_the_verify_buckets():
    """``compare_ids_batch`` buckets lanes to powers of two from 32; ids of
    up to 1,024 bytes land in the staged widths."""
    from repro_torch.core.verify import _bucket

    assert {_bucket(n, lo=32) for n in range(1, 257)} == set(STAGED_WIDTHS)


def _launch_counts():
    return (sorted_probe_cuda.launches, sorted_probe_cuda.direct_launches,
            sorted_probe_cuda.fenced_launches, hash_mix_cuda.launches,
            hash_mix_cuda.staged_launches, hash_mix_cuda.rowwise_launches)


@pytest.mark.parametrize("q,m", [(32, 100_000), (70_000, 1 << 17)])
def test_cpu_tensors_take_the_plain_versions(q, m):
    """On the CPU the entry points run the plain versions, at a serving
    request's shape and at a bulk batch's, and launch nothing."""
    rng = np.random.default_rng(q)
    table = np.sort(rng.integers(0, 2**64, m, dtype=np.uint64))
    keys = np.concatenate([table[rng.integers(0, m, q // 2)],
                           rng.integers(0, 2**64, q - q // 2, dtype=np.uint64)])
    tq, tt = torch.from_numpy(_pairs(keys)), torch.from_numpy(_pairs(table))
    x = torch.from_numpy(rng.integers(0, 2**32, (q, 32), dtype=np.uint32))
    pt = ProbeTable(tt)
    before = _launch_counts()
    found, pos = sorted_probe(tq, tt)
    f_pt, p_pt = sorted_probe(tq, pt)
    digests = hash_mix(x)
    assert _launch_counts() == before
    f_r, p_r = sorted_probe_ref(tq, tt)
    assert torch.equal(found, f_r) and torch.equal(pos, p_r)
    assert torch.equal(f_pt, f_r) and torch.equal(p_pt, p_r)
    assert torch.equal(digests.view(torch.int32), hash_mix_ref(x).view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sorted_probe_cuda(tq, tt)
    with pytest.raises(ValueError, match="CUDA"):
        sorted_probe_cuda(tq, pt)
    with pytest.raises(ValueError, match="CUDA"):
        hash_mix_cuda(x)
    assert _launch_counts() == before
