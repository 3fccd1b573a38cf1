"""``build_index`` over worker processes equals its one-process build, on the CPU.

With hashed keys, records collide, and ``ByteOffsetIndex.add`` keeps the
first location of a key and shadows the rest; so the merge order decides
which record a colliding key points at.  The port merges the workers'
results in ``store.files()`` order, whatever order they finish in, so that
``build_index(workers=k)`` equals the reference's ``workers=1`` build entry
for entry.  The corpus makes the first file many times larger than the
others (its records repeated), so that in a pool it finishes last.
"""

import functools

import pytest

import repro.core as R
import repro_torch.core as T
from repro_torch.core.sdfgen import CorpusSpec

KEY_BITS = 9     # 1,800 distinct records into 512 keys: every key collides
COPIES = 12      # the first file carries its own records and 12 copies of the rest


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ordered") / "corpus"
    T.generate_corpus(root, CorpusSpec(n_files=3, records_per_file=600))
    files = sorted(root.glob("compound_*.sdf"))
    rest = b"".join(p.read_bytes() for p in files[1:])
    with open(files[0], "ab") as f:
        for _ in range(COPIES):
            f.write(rest)
    return root


@functools.lru_cache(maxsize=None)
def _reference(root, key_mode):
    return R.build_index(R.RecordStore(root), key_mode=key_mode, workers=1,
                         key_bits=KEY_BITS, recompute_keys=True)


def _port(root, key_mode, workers):
    return T.build_index(T.RecordStore(root), key_mode=key_mode, workers=workers,
                         key_bits=KEY_BITS, recompute_keys=True)


def _same(a, b):
    assert list(a.entries.items()) == list(b.entries.items())
    assert {k: list(v) for k, v in a.shadowed.items()} == {
        k: list(v) for k, v in b.shadowed.items()}
    assert a.stats.n_duplicate_keys == b.stats.n_duplicate_keys


@pytest.mark.parametrize("workers", [2, 3, 4])
@pytest.mark.parametrize("key_mode", ["hashed_key", "full_id"])
def test_pool_build_equals_the_references_one_process_build(corpus, key_mode, workers):
    ref = _reference(corpus, key_mode)
    one = _port(corpus, key_mode, 1)
    pool = _port(corpus, key_mode, workers)
    _same(one, ref)
    _same(pool, ref)
    assert pool.stats.bytes_scanned == ref.stats.bytes_scanned
    if key_mode == "hashed_key":
        # the colliding keys point where the first file's records are
        first = sorted(corpus.glob("compound_*.sdf"))[0].name
        assert ref.stats.n_duplicate_keys > 0
        assert all(f == first for f, _ in pool.entries.values())


def test_pool_build_is_the_same_over_repeated_runs(corpus):
    builds = [_port(corpus, "hashed_key", 3) for _ in range(3)]
    for b in builds[1:]:
        _same(b, builds[0])
