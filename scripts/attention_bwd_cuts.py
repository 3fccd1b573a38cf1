"""Where the attention backward kernel's time goes, without a profiler.

    python3 scripts/attention_bwd_cuts.py [--out runs/attention_bwd_cuts.json]

Builds copies of ``src/repro_torch/csrc/flash_attention_bwd.cu`` with one
piece of the dK/dV pass cut (the results of a cut copy are wrong: only its
time is read), one ``nvcc`` per copy, all at once, and times the dK/dV and
dQ kernels of each (CUDA events, warm) at chip_smoke.py's three training
shapes (yi-6b, whisper-small's encoder, gemma3-12b's window).  The
difference between the whole kernel and a cut copy bounds what that piece
costs on the step's critical path.  The cuts:

* ``no_exp``: P without the exp2 (the MUFU work);
* ``no_handover``: no P^T through shared memory and no named barriers;
* ``no_second``: no dV / dK product (the A operand from registers);
* ``no_first``: no S^T / dP^T product (both operands from shared memory);
* ``no_columns``: no lse / D read from shared memory.

A cut whose text no longer matches the source is reported and skipped.
Needs one CUDA card and nvcc; prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
CUTS = {
    "whole": [],
    "no_exp": [(
        "float p = sm90::ex2(fmaf(x[e], a.scale_log2, -cv[8 * (e >> 2) + (e & 1)]));",
        "float p = fmaf(x[e], a.scale_log2, -cv[8 * (e >> 2) + (e & 1)]);")],
    "no_handover": [
        ("      if (i >= 2) sm90::named_sync(kBarEmpty + xb, 256);\n", ""),
        ("        xp[128 * j] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);\n",
         "        ;\n"),
        ("      __threadfence_block();\n      sm90::named_arrive(kBarFull + xb, 256);\n", ""),
        ("      sm90::named_sync(kBarFull + xb, 256);\n", ""),
        ("        const float4 p = xp[128 * j];\n",
         "        const float4 p = make_float4(1.f, 1.f, 1.f, 1.f);\n"),
        ("      if (i + 2 < n) sm90::named_arrive(kBarEmpty + xb, 256);\n", "")],
    "no_second": [(
        "    rs_product<DP>(acc, f, sm90::sw128_desc(b2_addr + s * S::kTile, kAtom, 1024));\n",
        "    acc[0] += __uint_as_float(f[0] ^ f[15]);\n")],
    "no_first": [(
        "    ss_product<DP>(x, da, kAtom, sm90::sw128_desc(b1_addr + s * S::kTile, 16, 1024), kAtom);\n",
        "    x[0] += 1.0f;\n")],
    "no_columns": [("    const float* cv = scols + s * 128 + cols + col0;\n",
                    "    const float cv[64] = {};\n")],
}


def build_cuts(workdir: Path):
    from repro_torch.kernels import build

    source = (CSRC / "flash_attention_bwd.cu").read_text()
    procs, skipped = [], []
    for name, cuts in CUTS.items():
        text = source
        if any(old not in text for old, _ in cuts):
            skipped.append(name)
            continue
        for old, new in cuts:
            text = text.replace(old, new)
        src, lib = workdir / f"bwd_{name}.cu", workdir / f"libbwd_{name}.so"
        src.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                   stderr=subprocess.STDOUT)))
    fns = {}
    for name, lib, p in procs:
        log = p.communicate()[0].decode(errors="replace")
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the {name} copy:\n{log[-4000:]}")
        f = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
        f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11
                      + [ctypes.POINTER(ctypes.c_uint64)] * 2 + [ctypes.c_int] * 9
                      + [ctypes.c_float, ctypes.c_void_p])
        f.restype = ctypes.c_int
        fns[name] = f
    return fns, skipped


def time_case(case, fns) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, map_dims

    name, b, hq, hkv, s, _, d, window, causal, _ = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for h in (hq, hkv, hkv))
    go = torch.randn((b, hq, s, d), generator=g, device=dev).to(torch.bfloat16)
    out, lse = flash_attention_cuda(q, k, v, causal, window, return_lse=True)
    pad = -(-s // 128) * 128
    lse2 = torch.empty((b, hq, pad), dtype=torch.float32, device=dev)
    delta = torch.empty_like(lse2)
    dq = torch.empty((b, hq, s, d), dtype=torch.bfloat16, device=dev)
    dk = torch.empty((b, hkv, s, d), dtype=torch.bfloat16, device=dev)
    dv = torch.empty_like(dk)
    maps = [map_dims(t) for t in (q, k, v, go)]
    dims = (ctypes.c_uint64 * 16)(*(x for m in maps for x in m["dims"]))
    strides = (ctypes.c_uint64 * 12)(*(x for m in maps for x in m["strides"]))
    res = {}
    for cut, fn in fns.items():
        def launch(kernel):
            err = fn(kernel, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     go.data_ptr(), lse.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dims, strides, b, hq, hkv,
                     s, s, d, int(causal), int(window is not None), window or 0,
                     d ** -0.5, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{cut}: kernel {kernel} launch failed ({err})")
        launch(0)
        res[cut] = {"dkdv_ms": cs.cuda_ms(lambda: launch(1), 20),
                    "dq_ms": cs.cuda_ms(lambda: launch(2), 20)}
    return {"case": name, "times": res}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "runs" / "attention_bwd_cuts.json"))
    args = ap.parse_args()
    import tempfile

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("attention_bwd_cuts: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    build.build(["flash_attention"])
    with tempfile.TemporaryDirectory(dir=ROOT / "runs" if (ROOT / "runs").is_dir()
                                     else None) as work:
        fns, skipped = build_cuts(Path(work))
        rows = [time_case(c, fns) for c in (cs.FA_TRAIN, cs.FA_TRAIN_WHISPER,
                                            cs.FA_TRAIN_WINDOW)]
    result = {"card": card, "skipped": skipped, "cases": rows}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()
