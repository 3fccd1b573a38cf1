"""Each plain reference against the port's plain path (CPU, float32, a
tiny configuration): the prefill's last logits, then every decode step's
logits through the cache or state, against the reference's logits of the
whole sequence at each position."""


import pytest
import torch

import program
import tiny
from reference import dense, ssm


@pytest.mark.parametrize("family,ref,body", [("dense", dense, tiny.DENSE),
                                             ("ssm", ssm, tiny.SSM)])
@pytest.mark.parametrize("n", [37, 70])
def test_reference_matches_the_port(family, ref, body, n):
    from repro_torch.models.registry import build_model

    c = dict(body, torch_dtype="float32")
    cfg, model = program.build(c, ref, 2 ** 33 + 5, "cpu")
    api = build_model(cfg)
    g = torch.Generator().manual_seed(n)
    seq = torch.randint(0, 256, (n + 6,), generator=g)
    prompt = seq[:n]
    logits, cache = api.prefill(model, {"tokens": prompt[None], "lengths": torch.tensor([n])},
                                max_len=n + 8)
    got = [logits[0]]
    for k in range(6):
        step, cache = api.decode_step(model, seq[n + k][None, None], torch.tensor([n + k]), cache)
        got.append(step[0])
    want = ref.logits(c, 2 ** 33 + 5, [seq[: n + 6]], [torch.arange(n - 1, n + 6)], "cpu")[0]
    got = torch.stack(got)
    scale = want.abs().max()
    assert torch.allclose(got.float(), want, atol=2e-4 * scale, rtol=0), \
        (got.float() - want).abs().max() / scale


def test_ssm_reference_absorbs_a_static_batch_padding():
    """A shorter prompt of a static batch decodes from the state over its
    right padding: the reference fed the same pads agrees."""
    from repro_torch.serve.engine import Engine, ServeConfig

    import check
    from types import SimpleNamespace

    c = dict(tiny.SSM, torch_dtype="float32")
    cfg, model = program.build(c, ssm, 9, "cpu")
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=5, max_len=64), device="cpu")
    texts = ["a" * 20, "bcd" * 12]
    res = eng.generate(texts)
    served = [{"text": t, "tokens": r.token_ids, "prompt_len": len(t) + 1,
               "pad_to": 37} for t, r in zip(texts, res)]
    ctx = SimpleNamespace(mix={"check": {"requests": 2}}, config=c, ref=ssm, seed=9,
                          device=torch.device("cpu"))
    assert check.gaps(ctx, served)["program"]["logit_gap_max"] < 1e-4
