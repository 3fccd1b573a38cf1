"""Serving launcher of the port's language models, static batch mode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full-config --seed 0

Builds the requested architecture (its reduced smoke config unless
``--full-config``) with random weights drawn on ``--device`` from
``--seed``, and serves the prompts through the static :class:`Engine`
``--repeats`` times, reporting prefill and decode timings.  ``--device``
defaults to ``cuda``; the CPU is used only when asked for.
``--continuous`` (the reference's paged-KV continuous batching) is not
ported yet.  :func:`run` drives it in-process and returns a summary.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from ..configs import ARCH_NAMES, get_config
from ..device import resolve_device
from ..models.registry import build_model
from ..serve.engine import Engine, ServeConfig

__all__ = ["build_parser", "main", "run"]

DEFAULT_PROMPTS = ["InChI=1S/C12H22O2/", "InChI=1S/C8H9NO2/"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="yi-6b")
    ap.add_argument("--full-config", action="store_true",
                    help="the published widths and depth (default: smoke config)")
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--repeats", type=int, default=1,
                    help="serve the prompts this many times")
    ap.add_argument("--continuous", action="store_true",
                    help="paged-KV continuous batching (not ported yet)")
    ap.add_argument("--prompts", nargs="*", default=DEFAULT_PROMPTS)
    return ap


def run(args: argparse.Namespace) -> Dict[str, object]:
    """Serve as ``args`` says (see :func:`build_parser`); returns a summary
    with every run's tokens and timings, and the ``engine`` itself for
    callers that go on serving (or profiling) the same model."""
    if args.continuous:
        raise SystemExit(
            "--continuous: the paged-KV continuous-batching engine is not "
            "ported yet (ROADMAP Queue 1 item 6b); drop --continuous"
        )
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if cfg.family == "vlm":
        print("note: vlm frontend stubbed — serving text-only prompts")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    model = build_model(cfg).init(gen, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=args.max_new_tokens,
                                         max_len=args.max_len), device=dev)
    print(f"serving {len(args.prompts)} prompts on {args.arch} "
          f"({'full' if args.full_config else 'smoke'} config, "
          f"{cfg.n_layers} layers, {cfg.dtype}, {dev})…")
    runs: List[Dict[str, object]] = []
    for _ in range(args.repeats):
        res = eng.generate(args.prompts)
        for i, r in enumerate(res):
            print(f"[{i}] prompt {r.prompt_len} tokens, prefill "
                  f"{r.prefill_s * 1e3:.1f} ms, {r.tokens_per_s:.1f} tok/s → "
                  f"{r.text[:60]!r}")
        steps, decode_s = res[0].steps, res[0].decode_s
        runs.append({
            "prefill_ms": res[0].prefill_s * 1e3,
            "decode_steps": steps,
            "decode_ms": decode_s * 1e3,
            "decode_tokens_per_s": len(res) * steps / decode_s if decode_s > 0 else 0.0,
            "token_ids": [r.token_ids for r in res],
        })
    return {
        "arch": args.arch,
        "config": "full" if args.full_config else "smoke",
        "n_layers": cfg.n_layers,
        "dtype": cfg.dtype,
        "device": str(dev),
        "batch": len(args.prompts),
        "prompt_tokens": [len(p.encode("utf-8")) + 1 for p in args.prompts],
        "init_s": init_s,
        "weight_bytes": weight_bytes,
        "kv_cache_bytes": eng.kv_cache_bytes,
        "runs": runs,
        "engine": eng,
    }


def main(argv: Optional[list] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
