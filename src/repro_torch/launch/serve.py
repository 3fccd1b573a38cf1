"""Serving launcher of the port's language models.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full-config --seed 0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --continuous --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small --full-config --max-len 448

Builds the requested architecture (its reduced smoke config unless
``--full-config``) with random weights drawn on ``--device`` from
``--seed``, and serves the prompts through the static :class:`Engine`
``--repeats`` times, reporting prefill and decode timings.  ``--device``
defaults to ``cuda``; the CPU is used only when asked for.  The VLM and
encoder-decoder families have stub frontends (as in the reference): the
engine feeds zero patch embeddings or zero audio frames.

``--continuous`` serves through the paged-KV continuous-batching engine
instead (:mod:`repro_torch.serve.scheduler`): the prompts are submitted as
independent requests that admit into ``--max-slots`` decode lanes backed
by ``--block-size`` KV blocks (the pool sized as the reference sizes it:
``max_slots · m`` blocks, ``m`` more of headroom for the prefix cache, and
2), and the report adds the TTFT/inter-token SLO percentiles and the
prefix-cache counters.  Prompts that share a block-aligned prefix share
its KV through the prefix cache (``--no-prefix-cache`` turns sharing off;
greedy tokens are the same either way).  Families without a paged
decode step (sliding-window layers, SSM, hybrid, encoder-decoder) refuse
``--continuous``.  :func:`run` drives either mode in-process and returns a
summary.

``--mesh DATAxMODEL`` serves the static engine over a DeviceMesh: the
weights laid out by their logical specs, the prompts over "data" (see
``serve/engine.py``).  A mesh of more than one device runs under torchrun,
one process per device, e.g. ``torchrun --nproc-per-node 2 -m
repro_torch.launch.serve --mesh 2x1 --device cpu``; ``1x1`` (the default)
serves without a mesh.  ``--continuous`` refuses a mesh other than
``1x1``, as the reference's launcher does.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from ..configs import ARCH_NAMES, get_config
from ..device import resolve_device
from ..models.registry import build_model
from ..models.specs import param_specs
from ..serve.engine import Engine, ServeConfig
from .mesh import mesh_from_str
from ..serve.kvcache import PagedCacheSpec, blocks_for
from ..serve.scheduler import ContinuousEngine

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
                    help="serve through the paged-KV continuous-batching engine")
    ap.add_argument("--max-slots", type=int, default=8,
                    help="decode batch width of the continuous engine")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV rows per paged-cache block")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="share block-aligned prompt prefixes across requests "
                         "(continuous mode; the same greedy tokens either way)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL device mesh of the static engine "
                         "(more than one device: run under torchrun)")
    ap.add_argument("--prompts", nargs="*", default=DEFAULT_PROMPTS)
    return ap


def run(args: argparse.Namespace) -> Dict[str, object]:
    """Serve as ``args`` says (see :func:`build_parser`); returns a summary
    with every run's tokens and timings, and the ``engine`` itself for
    callers that go on serving (or profiling) the same model."""
    dev = resolve_device(args.device)
    if args.continuous and args.mesh != "1x1":
        raise SystemExit("--continuous serves on one device; drop --mesh "
                         f"{args.mesh} (the continuous engine takes no mesh)")
    mesh = mesh_from_str(args.mesh, device=dev.type)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if cfg.family == "vlm":
        print("note: vlm frontend stubbed — serving text-only prompts")
    if cfg.family == "encdec":
        print(f"note: audio frontend stubbed — the encoder reads {cfg.enc_frames} "
              "zero frames")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t0 = time.perf_counter()
    model = build_model(cfg).init(gen, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    summary = {
        "arch": args.arch,
        "config": "full" if args.full_config else "smoke",
        "n_layers": cfg.n_layers,
        "dtype": cfg.dtype,
        "device": str(dev),
        "batch": len(args.prompts),
        "prompt_tokens": [len(p.encode("utf-8")) + 1 for p in args.prompts],
        "init_s": init_s,
        "weight_bytes": weight_bytes,
    }
    if args.continuous:
        return {**summary, **_run_continuous(args, cfg, model, dev)}
    eng = Engine(cfg, model, ServeConfig(max_new_tokens=args.max_new_tokens,
                                         max_len=args.max_len), device=dev,
                 mesh=mesh, param_specs=None if mesh is None else param_specs(model))
    print(f"serving {len(args.prompts)} prompts on {args.arch} "
          f"({'full' if args.full_config else 'smoke'} config, "
          f"{cfg.n_layers} layers, {cfg.dtype}, {dev}, mesh {args.mesh})…")
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
    return {**summary, "mesh": args.mesh, "kv_cache_bytes": eng.kv_cache_bytes,
            "runs": runs, "engine": eng}


def paged_spec(max_len: int, block_size: int, max_slots: int,
               prefix_cache: bool) -> PagedCacheSpec:
    """The reference launcher's pool: ``m = blocks_for(max_len)`` blocks a
    slot, ``max_slots · m``, ``m`` more of headroom when the prefix cache
    is on (its entries stay resident between requests), and the trash
    block plus one."""
    m = blocks_for(max_len, block_size)
    headroom = m if prefix_cache else 0
    return PagedCacheSpec(n_blocks=max_slots * m + headroom + 2,
                          block_size=block_size, max_slots=max_slots,
                          max_blocks_per_seq=m)


def _run_continuous(args, cfg, model, dev) -> Dict[str, object]:
    api = build_model(cfg)
    if not api.supports_paged:
        raise SystemExit(
            f"--arch {args.arch} has no paged-KV decode path (windowed "
            "attention, or the SSM, hybrid or encoder-decoder family); drop "
            "--continuous")
    spec = paged_spec(args.max_len, args.block_size, args.max_slots,
                      args.prefix_cache)
    eng = ContinuousEngine(
        cfg, model, spec,
        ServeConfig(max_new_tokens=args.max_new_tokens, max_len=spec.max_len),
        prefix_cache=args.prefix_cache, device=dev)
    print(f"serving {len(args.prompts)} prompts on {args.arch} "
          f"({'full' if args.full_config else 'smoke'} config, {cfg.n_layers} "
          f"layers, {cfg.dtype}, {dev}, continuous: {args.max_slots} slots x "
          f"{spec.max_blocks_per_seq} blocks of {args.block_size}, pool "
          f"{spec.n_blocks} blocks)…")
    runs: List[Dict[str, object]] = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        res = eng.generate(args.prompts)
        wall = time.perf_counter() - t0
        for i, r in enumerate(res):
            print(f"[{i}] prompt {r.prompt_len} tokens, prefill "
                  f"{r.prefill_s * 1e3:.1f} ms, {r.tokens_per_s:.1f} tok/s → "
                  f"{r.text[:60]!r}")
        n_tokens = sum(len(r.token_ids) for r in res)
        runs.append({"wall_ms": wall * 1e3, "tokens": n_tokens,
                     "tokens_per_s": n_tokens / wall if wall > 0 else 0.0,
                     "token_ids": [r.token_ids for r in res]})
    slo = eng.slo_ms()
    print(f"slo: ttft p50 {slo['ttft_p50_ms']:.1f} ms / p99 "
          f"{slo['ttft_p99_ms']:.1f} ms, itl p50 {slo['itl_p50_ms']:.2f} ms / "
          f"p99 {slo['itl_p99_ms']:.2f} ms")
    c = eng.counters()
    if "pfx_entries" in c:
        print(f"prefix cache: hit rate {c['prefix_hit_rate']:.2f} "
              f"({c['prefix_hits']:.0f}/{c['prefix_hits'] + c['prefix_misses']:.0f}), "
              f"{c['prefill_tokens_saved']:.0f} prefill tokens saved, "
              f"{c['pfx_entries']:.0f} entries resident")
    else:
        print("prefix cache: off")
    eng.check()
    eng.close()
    return {"continuous": True, "spec": dataclasses.asdict(spec), "runs": runs,
            "slo": slo, "counters": c, "engine": eng}


def main(argv: Optional[list] = None) -> None:
    run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
