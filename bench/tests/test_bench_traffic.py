"""The traffic generator: the same seed gives the same requests; another
seed other bytes, order and lengths, but one length from each band of
the mix's distributions every block, so that every length the
distribution can give arrives."""

import json

from traffic import Traffic, quantile

BENCH_MIXES = __import__("pathlib").Path(__file__).resolve().parents[1] / "mixes"


def _mix(name):
    return json.loads((BENCH_MIXES / f"{name}.json").read_text())


def _band(dist, strata, n):
    """The bands (by index) whose quantile range holds length ``n``."""
    edge = [quantile(dist, min(max(j / strata, 1e-9), 1 - 1e-9)) for j in range(strata + 1)]
    return {j for j in range(strata) if edge[j] <= n <= edge[j + 1]}


def test_same_seed_same_requests():
    a, b = Traffic(_mix("chat"), 2 ** 31 + 12345), Traffic(_mix("chat"), 2 ** 31 + 12345)
    assert [a.request(k) for k in range(70)] == [b.request(k) for k in range(70)]


def test_every_block_draws_one_length_from_each_band():
    for name in ("chat", "docs"):
        mix = _mix(name)
        strata = mix["strata"]
        a, b = Traffic(mix, 1), Traffic(mix, 2 ** 31 + 2)
        ra = [a.request(k) for k in range(4 * strata)]
        rb = [b.request(k) for k in range(4 * strata)]
        assert [r["text"] for r in ra] != [r["text"] for r in rb]
        assert sorted(r["prompt_len"] for r in ra) != sorted(r["prompt_len"] for r in rb)
        for key, dist in (("prompt_len", mix["prompt"]), ("budget", mix["output"])):
            for lo in range(0, 4 * strata, strata):
                for rs in (ra, rb):
                    bands = [_band(dist, strata, r[key]) for r in rs[lo:lo + strata]]
                    # a matching of the block's lengths onto distinct bands
                    used = set()
                    for cand in sorted(bands, key=len):
                        free = sorted(cand - used)
                        assert free, (name, key, [r[key] for r in rs[lo:lo + strata]])
                        used.add(free[0])


def test_the_clipped_ends_of_the_chat_mix_arrive():
    mix = _mix("chat")
    lens = [Traffic(mix, 9).request(k)["prompt_len"] for k in range(800)]
    assert max(lens) == mix["prompt"]["max"] and min(lens) < 300
    assert sum(n > 3500 for n in lens) >= 20


def test_docs_batches_differ_in_their_padded_length():
    t = Traffic(_mix("docs"), 77)
    longest = [max(r["prompt_len"] for r in t.batch(b)) for b in range(8)]
    assert len(set(longest)) > 4
    assert all(2048 <= r["prompt_len"] <= 4064 for b in range(8) for r in t.batch(b))
    assert all(len(r["text"]) + 1 == r["prompt_len"] for r in t.batch(0))


def test_prompts_fit_the_context():
    mix = _mix("chat")
    t = Traffic(mix, 5)
    for k in range(256):
        r = t.request(k)
        assert r["prompt_len"] + r["budget"] <= mix["max_len"]
        assert 0 <= r["seed"] < 2 ** 32
