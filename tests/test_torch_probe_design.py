"""The design of the port's ``sorted_probe`` and ``hash_mix`` kernels, on
the CPU.

``sorted_probe``'s kernel runs one branch-free lower-bound search per
query (``half = len >> 1``, ``len -= half``, move ``base`` by ``half``
when ``table[base + half - 1] < key``).  A Python twin of that search,
replayed here on tables with runs of equal keys, must give
``sorted_probe_ref``'s answer and ``repro``'s: the head of a run, the
found flag, and the positions past either end.  ``hash_mix``'s wrapper
picks its kernel with ``route``, a pure function of width and alignment,
and a CPU tensor takes the plain version and launches nothing.
"""

import numpy as np
import pytest
import torch

from repro.kernels.sorted_probe.ref import sorted_probe_ref as r_sorted_probe_ref
from repro_torch.kernels.hash_mix.kernel import STAGED_WIDTHS, hash_mix_cuda
from repro_torch.kernels.hash_mix.kernel import route as hash_route
from repro_torch.kernels.hash_mix.ops import hash_mix
from repro_torch.kernels.hash_mix.ref import hash_mix_ref
from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
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
    return (sorted_probe_cuda.launches, hash_mix_cuda.launches,
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
    before = _launch_counts()
    found, pos = sorted_probe(tq, tt)
    digests = hash_mix(x)
    assert _launch_counts() == before
    f_r, p_r = sorted_probe_ref(tq, tt)
    assert torch.equal(found, f_r) and torch.equal(pos, p_r)
    assert torch.equal(digests.view(torch.int32), hash_mix_ref(x).view(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        sorted_probe_cuda(tq, tt)
    with pytest.raises(ValueError, match="CUDA"):
        hash_mix_cuda(x)
    assert _launch_counts() == before
