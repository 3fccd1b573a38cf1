"""Chunked decode attention and ``make_serve_step`` against the reference,
on the CPU.

``decode_attention_chunked`` (an online softmax over KV chunks) must lie
within 1e-5 of the one-pass grouped products and of ``repro``'s
``decode_attention_chunked`` in float32, at a cache length that is not a
multiple of the chunk (the last chunk padded).  With
``flags.DECODE_CHUNKED`` set, the dense, ring-buffer and paged decode
steps read it at call time and stay within 1e-5 of the flag unset.
``make_serve_step`` is ``api.decode_step``, bit for bit.
"""

import copy
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import decode_attention_chunked as r_chunked
from repro_torch import flags
from repro_torch.configs import get_config
from repro_torch.models import common as C
from repro_torch.models import transformer as T
from repro_torch.models.registry import build_model
from repro_torch.train.loop import make_serve_step

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def _case(seed, b, h, hkv, s, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, dh)).astype(np.float32)
    pos = rng.integers(0, s, (b,))
    pos[0] = s - 1                      # one row sees the whole cache
    valid = np.arange(s)[None, :] <= pos[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("s,chunk", [(4133, 2048), (200, 64), (37, 2048)])
def test_chunked_matches_one_pass_and_reference(s, chunk):
    q, k, v, valid = _case(s, 3, 8, 2, s, 16)
    t = [torch.from_numpy(a) for a in (q, k, v, valid)]
    got = C.decode_attention_chunked(*t, chunk=chunk)
    assert got.shape == (3, 8, 16) and got.dtype == torch.float32
    one_pass = C._decode_ctx_local(*t).reshape(3, 8, 16)
    np.testing.assert_allclose(got.numpy(), one_pass.numpy(), **TOL)
    want = np.asarray(r_chunked(*(jnp.asarray(a) for a in (q, k, v, valid)),
                                chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_chunked_row_with_no_visible_key_is_zero():
    q, k, v, valid = _case(1, 2, 4, 4, 100, 8)
    valid[1] = False
    got = C.decode_attention_chunked(*(torch.from_numpy(a) for a in (q, k, v, valid)),
                                     chunk=32)
    assert torch.equal(got[1], torch.zeros_like(got[1]))


def _chunk_calls(monkeypatch, chunk):
    """Route the decode paths' chunked attention through a counter, at a
    chunk small enough for several chunks."""
    calls = []
    orig = C.decode_attention_chunked

    def counted(*a):
        calls.append(1)
        return orig(*a, chunk=chunk)

    monkeypatch.setattr(C, "decode_attention_chunked", counted)
    return calls


def _smoke(arch, **kw):
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32", **kw)
    api = build_model(cfg)
    return cfg, api, api.init(torch.Generator().manual_seed(6), "cpu")


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-12b"])
def test_decode_step_with_the_flag_matches_without(arch, monkeypatch):
    """The dense cache, and on gemma3 the ring buffer of its window layers,
    through several chunks (max_len 300 against a chunk of 2,048 would be
    one: the chunk is cut to 64)."""
    cfg, api, model = _smoke(arch)
    calls = _chunk_calls(monkeypatch, 64)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, 259, (2, 90)))
    lens = torch.tensor([90, 41])
    _, cache = api.prefill(model, {"tokens": toks, "lengths": lens}, max_len=300)
    tok = torch.from_numpy(rng.integers(0, 259, (2, 1)))
    out = {}
    for on in (False, True):
        monkeypatch.setattr(flags, "DECODE_CHUNKED", on)
        c = copy.deepcopy(cache)
        out[on] = [api.decode_step(model, tok, lens + i, c)[0] for i in range(3)]
        assert len(calls) == (3 * cfg.n_layers if on else 0)
    for a, b in zip(out[False], out[True]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def test_paged_decode_with_the_flag_matches_without(monkeypatch):
    cfg, api, model = _smoke("yi-6b")
    calls = _chunk_calls(monkeypatch, 16)
    bs, m = 8, 12
    pools = T.lm_paged_cache_init(cfg, 2 * m + 1, bs, "cpu")
    rng = np.random.default_rng(5)
    for pool in pools:
        for name in ("k", "v"):
            pool[name].copy_(torch.from_numpy(
                rng.standard_normal(tuple(pool[name].shape)).astype(np.float32)))
    tables = torch.arange(1, 2 * m + 1).reshape(2, m)
    tok = torch.from_numpy(rng.integers(0, 259, (2, 1)))
    pos = torch.tensor([70, 33])
    out = {}
    for on in (False, True):
        monkeypatch.setattr(flags, "DECODE_CHUNKED", on)
        out[on] = api.decode_step_paged(model, tok, pos, tables,
                                        copy.deepcopy(pools), bs)[0]
        assert len(calls) == (cfg.n_layers if on else 0)
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(), **TOL)


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-1.3b"])
def test_make_serve_step_is_the_decode_step(arch):
    cfg, api, model = _smoke(arch)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 259, (2, 12)))
    lens = torch.tensor([12, 7])
    logits, cache = api.prefill(model, {"tokens": toks, "lengths": lens}, max_len=40)
    tok = torch.argmax(logits, dim=-1)[:, None]
    want, want_cache = api.decode_step(model, tok, lens, copy.deepcopy(cache))
    got, got_cache = make_serve_step(api)(model, tok, lens, copy.deepcopy(cache))
    assert torch.equal(got, want)
    for a, b in zip(got_cache, want_cache):
        for name in a:
            assert torch.equal(a[name], b[name])
