"""Time the ``sample`` draws as the engines make them, on one CUDA card, for
the ``repro_torch`` package under ``--src`` (default: this checkout's), so
that two checkouts can be compared in one run on one card.

    python3 scripts/sample_timing.py [--src DIR] [--seed N] [--out FILE]

At B = 8 and the vocabularies of ``chip_smoke.SAMPLE_VOCABS`` (yi-6b's
64,000 and gemma3-12b's 262,144), through the package's own entry point
``kernels/sample/ops.py`` ``sample`` (the top-k threshold included) and,
beside it, its wrapper ``sample_cuda``: the static engine's bf16 draw with
the key split in place, and the continuous engine's float32 lane draw with
and without top-k 40 (``chip_smoke.sample_engine_draws``): device
milliseconds queued behind a sleep and back to back, host microseconds a
call, the kernels of one profiled call by name, the bound and its share.
The tokens of each draw are first held to the plain version of the
package under ``--src`` on the same card tensors.

``--variants a,b``: compile copies of this checkout's ``csrc/sample.cu``,
each with the text edits ``EDITS`` names (``built`` is the source as it
is; a ``GEOMETRY`` name runs it over other chunks), and time the kernel alone (``sample_cuda``, queued behind a sleep)
in the static bf16 draw and the top-k 40 lane draw at each vocabulary,
in turns; a variant that keeps the function is first held to the plain
version (``TIMING_ONLY`` ones compute something else and are only timed).

Prints one line per draw and the card's name and power limit, and writes
every number to ``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402  (the same timers and shapes)
    SAMPLE_NEAR_TIE, SAMPLE_ROWS, SAMPLE_SEED, SAMPLE_TEMPERATURE, SAMPLE_TOP_K,
    SAMPLE_VOCABS, queued_ms, sample_engine_draws)

# name -> [(text in csrc/sample.cu, its replacement), ...]
EDITS = {
    "built": [],
    # a launch that returns at once: the floor of a queued launch
    "empty": [("  __shared__ Shared sh;\n", "  __shared__ Shared sh;\n  if (a.vocab > 0) return;\n")],
    # no fold: every block returns after its ticket (the token is not written)
    "no-fold": [("  if (!sh.last) return;\n", "  if (a.vocab > 0) return;\n")],
    # the fold takes its first listed key as the threshold: its select's cost
    "fold-select-off": [
        ("        copied ? block_select(u, k, [&](int e) { return sh.fold_key[e]; }, sh).kth\n"
         "               : block_select(u, k, [&](int e) { return __ldcg(lk + e); }, sh).kth;",
         "        __ldcg(lk);")],
    # the draw loop unrolled by four: the threefry chains of four logits
    # interleaved
    "ilp": [("    for (int j = begin + tid; j < end; j += kThreads) {\n      const float l = scaled",
             "#pragma unroll 4\n    for (int j = begin + tid; j < end; j += kThreads) {\n      const float l = scaled")],
    # a top-k chunk does not score its listed logits: the cost of their threefry
    "topk-no-draw": [("          draw<kBf16>(a, k0, k1, base, row, j, scaled<In, kBf16>(src, j, a.inv_t));",
                      "          0.0f;")],
    # the arrival's fences as fence.acq_rel.gpu, not __threadfence's fence.sc.gpu
    "fence-acqrel": [
        ("    __threadfence();\n    const bool last", "    asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");\n    const bool last"),
        ("    if (last) __threadfence();", "    if (last) asm volatile(\"fence.acq_rel.gpu;\" ::: \"memory\");")],
    # every select ends after its first round (a wrong k-th): what its
    # later rounds cost
    "round1-exit": [("    if (want == 1 && shift > 0) {", "    if (shift > 0) {")],
    # every chunk lists all its logits (into the spare room of the lists):
    # the chunk's select's cost
    "chunk-select-off": [("    if (n > k) {\n      const Select sel", "    if (n < 0) {\n      const Select sel")],
}
TIMING_ONLY = ("empty", "no-fold", "fold-select-off", "chunk-select-off", "topk-no-draw",
               "round1-exit")
# the source as built, over other chunks: (PART_ELEMS, SM_BLOCKS) in
# kernels/sample/kernel.py
GEOMETRY = {"blocks8": (512, 1056), "chunks2x": (2048, 264), "chunks4x": (4096, 132)}


def compile_variant(name: str, build) -> ctypes.CDLL:
    text = (build.CSRC / "sample.cu").read_text()
    for old, new in EDITS.get(name, []):
        if old not in text:
            raise SystemExit(f"sample_timing: edit {name} does not apply")
        text = text.replace(old, new)
    out = build.BUILD_ROOT / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"sample-{name}.cu", out / f"libsample-{name}.so"
    cu.write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(so), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(so))


def variants(names, seed: int, card: str) -> dict:
    """Time each variant's kernel, in turns, at each vocabulary."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.sample import kernel
    from repro_torch.kernels.sample import ref as S

    libs = {n: compile_variant(n, build) for n in names}
    defaults = kernel.PART_ELEMS, kernel.SM_BLOCKS
    dev = torch.device("cuda")
    out = {}
    for arch in SAMPLE_VOCABS:
        v = get_config(arch).vocab_size
        g = torch.Generator(device=dev).manual_seed(seed + 11)
        lg = torch.randn((SAMPLE_ROWS, v), generator=g, device=dev) * 4
        bf16 = lg.to(torch.bfloat16)
        seeds = torch.randint(-2**31, 2**31, (SAMPLE_ROWS,), generator=g, device=dev,
                              dtype=torch.int32)
        inv_b = S.inv_temperature(SAMPLE_TEMPERATURE, torch.bfloat16)
        inv_f = S.inv_temperature(SAMPLE_TEMPERATURE, torch.float32)
        key = S.prng_key(SAMPLE_SEED, dev)
        kth = S.top_k_threshold(lg, SAMPLE_TOP_K, inv_f, torch.float32)
        scores = S.sample_scores(lg, inv_f, torch.float32, seeds=seeds, index=seeds, kth=kth)
        want = torch.argmax(scores, dim=-1).to(torch.int32)
        draws = {
            "static bf16": lambda: kernel.sample_cuda(bf16, inv_b, torch.bfloat16,
                                                      keys=key, split_key=True),
            "top-k": lambda: kernel.sample_cuda(lg, inv_f, torch.float32, seeds=seeds,
                                                index=seeds, top_k=SAMPLE_TOP_K),
        }
        for turn in (*names, *reversed(names)):
            lib = libs[turn]
            kernel.PART_ELEMS, kernel.SM_BLOCKS = GEOMETRY.get(turn, defaults)
            kernel._LIB, saved = None, kernel.load
            kernel.load = lambda _name, lib=lib: lib
            try:
                kernel._lib()
            finally:
                kernel.load = saved
            if turn not in TIMING_ONLY:
                got = draws["top-k"]()
                if ((got != want) & (S.top_two_gap(scores) > SAMPLE_NEAR_TIE)).any():
                    raise SystemExit(f"sample_timing: variant {turn} draws other tokens")
            for name, draw in draws.items():
                ms = queued_ms(draw, 100)
                out.setdefault(f"{turn} {name} V={v}", []).append(ms)
                print(f"variant[{turn}, {name}, V={v}]: kernel_ms={ms:.6f} (queued); "
                      f"card: {card}", flush=True)
            for counters in kernel.arrival_counters():  # a variant without a fold
                counters.zero_()                       # leaves them raised
        kernel._LIB = None
    kernel.PART_ELEMS, kernel.SM_BLOCKS = defaults
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--variants", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sample_timing: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.variants:
        out = variants(args.variants.split(","), args.seed, card)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps({"card": card, "variants": out}, indent=1))
        return
    # chip_smoke put this checkout's src on the path: time the one in --src
    sys.path.insert(0, str(args.src.resolve()))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    ops = importlib.import_module("repro_torch.kernels.sample.ops")
    kernel = importlib.import_module("repro_torch.kernels.sample.kernel")
    S = importlib.import_module("repro_torch.kernels.sample.ref")
    configs = importlib.import_module("repro_torch.configs")
    print(f"card: {card}; src: {args.src} ({Path(kernel.__file__).resolve()})", flush=True)

    dev = torch.device("cuda")
    out = {"card": card, "src": str(args.src), "draws": {}}
    for arch in SAMPLE_VOCABS:
        v = configs.get_config(arch).vocab_size
        g = torch.Generator(device=dev).manual_seed(args.seed + 11)
        logits32 = torch.randn((SAMPLE_ROWS, v), generator=g, device=dev) * 4
        seeds = torch.randint(-2**31, 2**31, (SAMPLE_ROWS,), generator=g, device=dev,
                              dtype=torch.int32)
        index = torch.randint(0, 32, (SAMPLE_ROWS,), generator=g, device=dev,
                              dtype=torch.int32)
        inv_t = S.inv_temperature(SAMPLE_TEMPERATURE, torch.float32)
        kth = S.top_k_threshold(logits32, SAMPLE_TOP_K, inv_t, torch.float32)
        scores = S.sample_scores(logits32, inv_t, torch.float32, seeds=seeds,
                                 index=index, kth=kth)
        got = ops.sample(logits32, SAMPLE_TEMPERATURE, seeds=seeds, index=index,
                         top_k=SAMPLE_TOP_K, dtype=torch.float32)
        want = torch.argmax(scores, dim=-1).to(torch.int32)
        if ((got != want) & (S.top_two_gap(scores) > SAMPLE_NEAR_TIE)).any():
            raise SystemExit(f"sample_timing: V={v} top-k tokens differ from the plain "
                             "version's outside a near-tie")
        timed = sample_engine_draws(ops.sample, kernel.sample_cuda, S, logits32, seeds,
                                    index)
        out["draws"][str(v)] = timed
        del logits32, scores
        torch.cuda.empty_cache()
    print(f"nvidia-smi: {card}; seed {SAMPLE_SEED}", flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
