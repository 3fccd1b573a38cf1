"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed S]

1. Device: the card's name and power limit (``nvidia-smi``), then every CUDA
   source of the port built with nvcc (one process per source, all at once).
2. Kernels against their plain PyTorch versions, on the card, at the
   paper's scale: ``sorted_probe`` over a sorted 176,929,690-entry digest
   plane (PubChem's count) with 477,123 queries (ChEMBL ∩ eMolecules), of
   which 435,413 (the extracted count) are drawn from the plane, plus a
   24-bit table with duplicate runs, each timed warm and cold (L2 flushed
   before each launch) with ``torch.searchsorted`` beside it the same two
   ways, and a serving request's shape (32 keys in a 100,000-entry plane),
   timed on the device with the calls queued behind a sleep (so the host's
   enqueue time is hidden), cold, and on the host per call; ``hash_mix`` over
   the 1,048,576 x 128 verify batch that ``compare_ids_batch`` forms for
   435,413 pairs, the same rows at 32 and 64 lanes, the funnel's largest
   verify batch (4,096 x 128) and a slice 4 bytes off 16-byte alignment,
   each on its route, warm and cold.  Outputs must match bit for bit.
   ``tanimoto`` top-k against its plain version,
   scores as raw float32 bits and rows exactly: ``pubchem``, a plane of
   176,929,690 random 1,024-bit fingerprints (22.6 GB, generated on the
   card in chunks) screened by 64 queries at k = 32; ``ties``, 4,194,304
   rows drawn from 4,096 distinct fingerprints, shuffled, screened by 256
   queries (rows of the plane, all-zero queries, random ones) at k = 1,
   32, 1,024 and 2,048, and on its first 5,000 rows at k = 8,192 (k > N:
   pads, and the stage-1 lists in global memory).  ``flash_attention``
   against its plain version in bfloat16 at the LM prefill's shape (yi-6b:
   B = 8, Hq = 32, Hkv = 4, S = 2,048, D = 128, causal) and at gemma3-12b's
   (B = 1, Hq = 16, Hkv = 8, S = 4,096, D = 256, window 1,024), both on
   the tensor-core route, held to the plain version's float32 output on
   the same values within 2^-8 |ref| + 2^-8 A(|v|) + 1e-4 (the bf16
   rounding of the output and of P; ``flash_attention_ref.bound_excess``),
   a bound that a variant losing one key tile must exceed, with
   ``torch.nn.functional.scaled_dot_product_attention`` timed beside it
   and its output read under the same bound and the output-cast-only one.
   After the build, ptxas must report no spills in ``flash_attention.cu``,
   ``sorted_probe.cu`` and ``hash_mix.cu``, and ``cuobjdump -sass`` must
   show each redesigned kernel's instruction (``DESIGN_OPCODES``):
   ``HGMMA`` and ``UTMALDG`` in the tensor-core attention kernel,
   ``LDGSTS`` (``cp.async``) in the staged kernel of ``hash_mix``.
   Prints each kernel's time, the plain version's, a PyTorch library
   call's where one computes the same function, and the least time the
   card could take (its bound).  ``ssd_scan`` against its plain version,
   bit for bit, in float32 at mamba2-1.3b's served prefill shape (BH =
   8 x 64 heads, C = 8 chunks of 256, P = 64, N = 128) and at one
   65,536-token prompt's (BH = 64, C = 256); states from ``randn``, decay
   uniform in [0, 1); no PyTorch call computes the scan (``library_ms``
   null).
3. The funnel end to end on the card through ``repro_torch.launch.funnel``
   (corpus, index, publish, intersect, lookup_batch, extract + verify) at
   100,000 records, plus an extraction through 17-bit hashed keys whose
   collisions the device verifier must reject as the string verifier does,
   with every kernel's launch counts (in all, and per route) set to 0 just
   before and read just after: each kernel must have launched on that path.
   The 17-bit phase's mismatch count must equal ``HASHED_MISMATCHES`` and
   the count through an index built by one process on the same corpus,
   whose entries the pool build's must equal.
4. The query service on the funnel's corpus and store through
   ``repro_torch.launch.serve_index`` on the card (2 replicas, 8 clients,
   2 s per arm): lookup mode with its ``svc.fetch == serial extract``
   parity gate, and similarity mode at k = 8 with its ``svc.similar ==
   per-query similar_batch(probe="host")`` gate (the card's kernel against
   the host's plain version).  Launch counts are set to 0 before the phase
   and read after it: ``sorted_probe``, ``hash_mix`` and ``tanimoto`` must
   each have launched there.
5. A model check at full width: yi-6b cut to 2 layers, in float32 with
   TF32 off, weights made once and loaded into a card model and a CPU
   model; the prefill logits of two ragged prompts (at most 256 bytes, from
   the funnel's corpus) must agree within ``MODEL_ATOL``/``MODEL_RTOL``,
   and the card's prefill must have launched ``flash_attention`` once per
   layer.
6. LM serving through ``repro_torch.launch.serve.run``: yi-6b at its
   published widths and full depth (32 layers) in bfloat16, random weights
   drawn on the card from ``--seed``, 8 prompts cut from the funnel's
   corpus records to 17 ... 2,047 bytes (2,048 tokens with BOS, so the
   padded prefill is B = 8 x S = 2,048), 32 new tokens, ``max_len``
   4,096, served twice: the two runs must give the same tokens, and
   ``flash_attention`` must have launched exactly once per layer per
   prefill, all on the tensor-core route (launch counts set to 0 just
   before the phase).  Then a third
   ``generate`` of the served engine under ``torch.profiler``: for its
   prefill and its decode, the card's busy share and the kernels that take
   the most device time.
7. A model check of the recurrent families, in float32 with TF32 off,
   weights made once and loaded into a card model and a CPU model:
   mamba2-1.3b at full width cut to 2 layers, and jamba-1.5-large-398b's
   smoke config (no hybrid config of the repo fits one card).  The prefill
   logits of two ragged corpus prompts (601 and 98 tokens) must agree
   within ``MODEL_ATOL``/``MODEL_RTOL``; ``ssd_scan`` must launch once per
   Mamba layer, and on the hybrid ``flash_attention`` once per super-block.
8. SSM serving through ``repro_torch.launch.serve.run``: mamba2-1.3b at
   its published widths and full depth (48 layers, d_model 2,048, 64 SSD
   heads of 64, state 128), bfloat16, random weights drawn on the card
   from ``--seed``, the same 8 prompts as step 6, 32 new tokens, served
   twice: the two runs must give the same tokens, and ``ssd_scan`` must
   have launched exactly 48 times per prefill and never in decode (launch
   counts set to 0 just before the phase).  Then the served engine under
   ``torch.profiler``, as in step 6.
9. A ``{"kernels": [...]}`` line, the card line, and as the last line
   ``{"ok": true, "device": {...}}``.  Any failure exits non-zero before it.

Needs one CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the HBM3
# rate, and the 32-bit integer rate: half the 67e12 FP32 CUDA-core rate,
# since a Hopper SM has 64 INT32 lanes against 128 FP32 lanes.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12

L2_FLUSH_BYTES = 256 << 20  # written between cold launches: 5x the H100's 50 MB L2
PUBCHEM = 176_929_690      # table entries (the paper's PubChem count)
QUERIES = 477_123          # ChEMBL ∩ eMolecules
FROM_PLANE = 435_413       # of which present in PubChem (the extracted count)
DUP_TABLE = 1 << 22        # the duplicate-run case: 24-bit digests
VERIFY_ROWS = 1 << 20      # 2 x 435,413 rows bucketed to a power of two
VERIFY_LANES = 128         # 112 lanes (431-byte ids) bucketed
FUNNEL_VERIFY_ROWS = 4096  # the funnel's largest verify batch at 100,000 records
SERVE_PLANE = 100_000      # serving-shaped probe: the funnel store's plane ...
SERVE_KEYS = 32            # ... and a few dozen keys of a coalesced request
SLEEP_CYCLES = 20_000_000  # about 10 ms at 1.98 GHz: longer than a timed enqueue
HOST_CALLS = 10_000        # calls timed on the host's clock
HASH_OPS_PER_LANE = 19     # integer ops per (row, lane) in hash_mix's loop
FUNNEL_RECORDS = 100_000   # 8 files x 12,500 records, about 207 MB of SDF
# mismatches the funnel's 17-bit hashed-key phase rejects at seed 0: the
# count of a workers=1 index (the merge no longer depends on worker order)
HASHED_MISMATCHES = 405
FP_WORDS = 32              # 1,024-bit fingerprints (the store's default)
SIM_QUERIES = 64           # pubchem case: a service batch of queries
SIM_K = 32                 # the service's similar_top_k
TIES_ROWS = 1 << 22        # ties case: 4,194,304 rows ...
TIES_DISTINCT = 4096       # ... drawn from 4,096 distinct fingerprints
TIES_QUERIES = 256
TIES_KS = (1, 32, 1024, 2048)
PADS_ROWS = 5_000          # ties plane cut to 5,000 rows ...
PADS_K = 8_192             # ... at k > N: pads, lists in global memory
BF16_FLOPS_PER_S = 989e12  # tensor-core bf16 peak (H100 SXM, dense)
# flash_attention cases: (name, B, Hq, Hkv, S, D, window)
FA_YI = ("yi-6b", 8, 32, 4, 2048, 128, None)
FA_GEMMA = ("gemma3-12b", 1, 16, 8, 4096, 256, 1024)
# flash_attention in bfloat16 against the plain version's float32 output on
# the same values (``bound_excess`` of the plain version's module):
#   CUDA-core route: |err| <= u |ref| + atol, u = 2^-8 the bf16 cast's
#     rounding (half a step: 8 significant bits), atol = 1e-4 float32
#     arithmetic (the f32 card tests agree within 2e-5);
#   tensor-core route: |err| <= u |ref| + u A(|v|) + atol.  The kernel also
#     rounds each p_j to bf16 before P V, which moves p_j by at most u p_j
#     and the output by at most u sum_j p_j |v_j| / l = u A(|v|), where
#     A(|v|) = flash_attention_ref(q, k, |v|): derived from the arithmetic,
#     not fitted to the data.  SDPA's flash kernel rounds P the same way.
# A known-wrong variant, the plain version that loses the first FA_DROP keys
# of every row, must read above the bound used, or the check could not see
# a lost key tile.
FA_DROP = 64
F32_FLOPS_PER_S = 67e12    # float32 on the CUDA cores (H100 SXM)
# ssd_scan cases: (name, BH, C, P, N).  "prefill" is mamba2-1.3b's served
# prefill (B = 8 x 64 heads, padded S = 2,048 in chunks of 256); "long" one
# 65,536-token prompt (256 chunks)
SSD_PREFILL = ("prefill", 512, 8, 64, 128)
SSD_LONG = ("long-prompt", 64, 256, 64, 128)
MODEL_LAYERS = 2           # the model check's depth cut
SSM_MODEL_LENGTHS = (600, 97)  # prompt bytes: 601 tokens span 3 chunks of 256
MODEL_ATOL = MODEL_RTOL = 1e-3  # float32 logits, card vs CPU, 2 layers
SERVE_LENGTHS = (17, 64, 160, 384, 768, 1152, 1600, 2047)  # prompt bytes
SERVE_NEW_TOKENS = 32
SERVE_MAX_LEN = 4096
PLANE_CHUNK = 1 << 23      # rows generated (and counted) per step on the card
PLAIN_ELEMS = 1 << 26      # (query, row) pairs per block of the plain version
# __popc throughput of compute capability 9.0: 16 results per clock per SM
# (CUDA C++ Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
M32 = 0xFFFFFFFF
SIGN = -(2**63)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int, flush: torch.Tensor, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls, each timed
    alone (CUDA events) after ``flush`` (a buffer larger than the card's
    L2) is written, so that every call finds L2 cold."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn`` over ``reps`` calls queued behind a
    sleep, so that the host's time to enqueue them is hidden."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timed(fn):
    """``(fn(), device milliseconds of that one call)`` (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def popc_per_s() -> float:
    """The card's __popc rate: 16 per clock per SM, at its maximum SM clock
    (``nvidia-smi clocks.max.sm``) over all its SMs."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return POPC_PER_CLOCK_PER_SM * sms * float(mhz) * 1e6


def keys_to_pairs(keys: torch.Tensor) -> torch.Tensor:
    """Sign-flipped int64 keys → ``(N, 2)`` uint32 ``(hi, lo)`` pairs."""
    from repro_torch.kernels.hash_mix.ref import to_u32

    u = keys ^ SIGN
    return to_u32(torch.stack([(u >> 32) & M32, u & M32], dim=1)).contiguous()


def search_sectors(keys: torch.Tensor, qk: torch.Tensor) -> int:
    """Distinct 32-byte table sectors a lower-bound search of ``qk`` reads.

    Replays the kernel's branch-free search (the step widths do not depend
    on the data, only the bases do) and counts the sectors it touches.
    """
    m = keys.numel()
    base = torch.zeros_like(qk)
    length = m
    touched = []
    while length > 1:
        half = length >> 1
        idx = base + (half - 1)
        touched.append(idx)
        base = torch.where(keys[idx] < qk, base + half, base)
        length -= half
    touched.append(base)
    return int(torch.unique(torch.cat(touched) // 4).numel())


def probe_case(name, keys, qk, reps, note, flush, serving=False):
    """Hold sorted_probe's kernel to its plain version on one table; time it
    and ``torch.searchsorted`` warm (or, for a serving request, queued
    behind a sleep, and on the host) and cold (L2 flushed before each
    launch)."""
    from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
    from repro_torch.kernels.sorted_probe.ref import sorted_probe_ref

    table = keys_to_pairs(keys)
    queries = keys_to_pairs(qk)
    q, m = qk.numel(), keys.numel()
    before = sorted_probe_cuda.launches
    f_k, p_k = sorted_probe_cuda(queries, table)
    f_r, p_r = sorted_probe_ref(queries, table)
    torch.cuda.synchronize()
    if sorted_probe_cuda.launches != before + 1:
        fail(f"sorted_probe {name}: the call did not count one launch")
    if not (torch.equal(f_k, f_r) and torch.equal(p_k, p_r)):
        bad = int((f_k != f_r).sum() + (p_k != p_r).sum())
        fail(f"sorted_probe {name}: kernel disagrees with plain version ({bad} outputs)")
    err = int((p_k.to(torch.int64) - p_r.to(torch.int64)).abs().max())
    err = max(err, int((f_k != f_r).sum()))
    kernel = lambda: sorted_probe_cuda(queries, table)  # noqa: E731
    library = lambda: torch.searchsorted(keys, qk)  # noqa: E731
    warm = queued_ms if serving else cuda_ms
    ms = warm(kernel, reps)
    cold = cold_ms(kernel, 20, flush)
    plain = cuda_ms(lambda: sorted_probe_ref(queries, table), 3, warmup=1)
    lib_ms = warm(library, reps)
    lib_cold = cold_ms(library, 20, flush)
    host = (f" host_us={host_us(kernel, HOST_CALLS):.3f} "
            f"library_host_us={host_us(library, HOST_CALLS):.3f}") if serving else ""
    sectors = search_sectors(keys, qk)
    nbytes = sectors * 32 + q * 8 + q * (1 + 4)
    steps = max(1, (m - 1).bit_length()) + 1
    b, by = bound_ms(nbytes, q * steps * 3)
    hits = int(f_k.sum())
    how = "queued" if serving else "warm"
    print(f"sorted_probe[{name}]: M={m} Q={q} hits={hits} {note} "
          f"bit-exact; kernel_ms={ms:.6f} ({how}) kernel_cold_ms={cold:.6f} "
          f"plain_ms={plain:.6f} library_ms(searchsorted)={lib_ms:.6f} ({how}) "
          f"library_cold_ms={lib_cold:.6f}{host} sectors={sectors} bytes={nbytes} "
          f"bound_ms={b:.6f} ({by})", flush=True)
    del table, queries
    return dict(ms=ms, plain_ms=plain, library_ms=lib_ms, bound_ms=b,
                bound_by=by, max_abs_err=err)


def hash_case(name, x, reps, flush):
    """Hold hash_mix's kernel to its plain version bit for bit on ``x``, on
    the route the wrapper picks; time it warm and cold."""
    from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda, route
    from repro_torch.kernels.hash_mix.ref import hash_mix_ref

    n, w = x.shape
    path = route(w, x.data_ptr())
    on_route = getattr(hash_mix_cuda, f"{path}_launches")
    out_k = hash_mix_cuda(x)
    out_r = hash_mix_ref(x)
    torch.cuda.synchronize()
    if getattr(hash_mix_cuda, f"{path}_launches") != on_route + 1:
        fail(f"hash_mix {name}: the launch left the {path} route")
    a = out_k.view(torch.int32).to(torch.int64) & M32
    b = out_r.view(torch.int32).to(torch.int64) & M32
    err = int((a - b).abs().max())
    if err != 0:
        fail(f"hash_mix {name}: kernel disagrees with plain version (max_abs_err {err})")
    ms = cuda_ms(lambda: hash_mix_cuda(x), reps)
    cold = cold_ms(lambda: hash_mix_cuda(x), 20, flush)
    plain = cuda_ms(lambda: hash_mix_ref(x), 2, warmup=1)
    nbytes = n * w * 4 + n * 16
    ops = n * w * HASH_OPS_PER_LANE
    bnd, by = bound_ms(nbytes, ops)
    print(f"hash_mix[{name}]: N={n} W={w} route={path} bit-exact; "
          f"kernel_ms={ms:.6f} (warm) kernel_cold_ms={cold:.6f} "
          f"plain_ms={plain:.6f} library_ms=null bytes={nbytes} ops={ops} "
          f"bound_ms={bnd:.6f} ({by}) share_of_bound={bnd / ms:.3f}", flush=True)
    del out_k, out_r, a, b
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def random_u32(g, shape, dev) -> torch.Tensor:
    from repro_torch.kernels.hash_mix.ref import to_u32

    return to_u32(torch.randint(0, 2**32, shape, generator=g, device=dev,
                                dtype=torch.int64)).contiguous()


def tanimoto_case(name, q, db, dc, ks, reps, popc_rate):
    """Hold tanimoto's kernel to its plain version, bit for bit, at each k;
    time both at the first k."""
    from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
    from repro_torch.kernels.tanimoto.ref import row_counts, tanimoto_topk_ref

    qc = row_counts(q)
    n, w = db.shape
    nq = q.shape[0]
    chunk = max(1 << 16, PLAIN_ELEMS // nq)  # bounds the plain version's blocks
    out = None
    for k in ks:
        (s_k, i_k), ms = timed(lambda: tanimoto_topk_cuda(q, db, k, qc, dc))
        (s_r, i_r), plain = timed(
            lambda: tanimoto_topk_ref(q, db, k, qc, dc, db_chunk=chunk))
        bits_k, bits_r = s_k.view(torch.int32), s_r.view(torch.int32)
        if not (torch.equal(bits_k, bits_r) and torch.equal(i_k, i_r)):
            bad = int((bits_k != bits_r).sum() + (i_k != i_r).sum())
            fail(f"tanimoto {name} k={k}: kernel disagrees with plain version "
                 f"({bad} outputs)")
        err = float((s_k - s_r).abs().max())
        ties = int((s_k[:, 1:] == s_k[:, :-1]).sum()) if k > 1 else 0
        if out is None:
            ms = cuda_ms(lambda: tanimoto_topk_cuda(q, db, k, qc, dc), reps,
                         warmup=1)
            nbytes = n * (4 * w + 4) + nq * (4 * w + 4) + nq * k * 8
            ops = nq * n * w
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = ops / popc_rate * 1e3
            b, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            print(f"tanimoto[{name}]: N={n} W={w} Q={nq} k={k} bit-exact "
                  f"({ties} equal-score neighbours in the top-k); "
                  f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms=null "
                  f"bytes={nbytes} popcounts={ops} popc_per_s={popc_rate:.4g} "
                  f"bound_ms={b:.6f} ({by})", flush=True)
            out = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b,
                       bound_by=by, max_abs_err=err)
        else:
            print(f"tanimoto[{name}]: k={k} bit-exact ({ties} equal-score "
                  f"neighbours); kernel_ms={ms:.6f} (one call) "
                  f"plain_ms={plain:.6f}", flush=True)
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del s_k, i_k, s_r, i_r, bits_k, bits_r
    return out


def tanimoto_phase(seed: int):
    """``pubchem`` and ``ties`` cases of the tanimoto kernel."""
    from repro_torch.kernels.tanimoto.ref import row_counts

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    rate = popc_per_s()

    # -- pubchem: the plane at PubChem's row count, generated in chunks -----
    t0 = time.perf_counter()
    db = torch.empty((PUBCHEM, FP_WORDS), dtype=torch.uint32, device=dev)
    dc = torch.empty(PUBCHEM, dtype=torch.int32, device=dev)
    for lo in range(0, PUBCHEM, PLANE_CHUNK):
        hi = min(lo + PLANE_CHUNK, PUBCHEM)
        chunk = random_u32(g, (hi - lo, FP_WORDS), dev)
        db.view(torch.int32)[lo:hi].copy_(chunk.view(torch.int32))
        dc[lo:hi] = row_counts(chunk)
        del chunk
    q = random_u32(g, (SIM_QUERIES, FP_WORDS), dev)
    rows = torch.randint(0, PUBCHEM, (SIM_QUERIES // 4,), generator=g, device=dev)
    q.view(torch.int32)[: SIM_QUERIES // 4] = db.view(torch.int32)[rows]
    torch.cuda.synchronize()
    print(f"tanimoto[pubchem]: plane {PUBCHEM} x {FP_WORDS} words "
          f"({PUBCHEM * (4 * FP_WORDS + 4)} bytes) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    main = tanimoto_case("pubchem", q, db, dc, (SIM_K,), reps=3, popc_rate=rate)
    del db, dc, q, rows
    torch.cuda.empty_cache()

    # -- ties: 4,096 distinct fingerprints, each about 1,024 times ----------
    base = random_u32(g, (TIES_DISTINCT, FP_WORDS), dev)
    base.view(torch.int32)[0] = 0  # all-zero rows: u = 0 against zero queries
    pick = torch.randint(0, TIES_DISTINCT, (TIES_ROWS,), generator=g, device=dev)
    db = base.view(torch.int32)[pick].view(torch.uint32).contiguous()
    dc = row_counts(db)
    q = random_u32(g, (TIES_QUERIES, FP_WORDS), dev)
    qi = q.view(torch.int32)
    qi[: TIES_QUERIES // 2] = db.view(torch.int32)[
        torch.randint(0, TIES_ROWS, (TIES_QUERIES // 2,), generator=g, device=dev)]
    qi[TIES_QUERIES // 2: TIES_QUERIES // 2 + 16] = 0
    tanimoto_case("ties", q, db, dc, TIES_KS, reps=3, popc_rate=rate)
    # k > N on the plane's first rows: pads, and lists too long for shared
    # memory even at one query per warp
    head = db[:PADS_ROWS].contiguous()
    tanimoto_case("ties-pads", q, head, dc[:PADS_ROWS].contiguous(), (PADS_K,),
                  reps=3, popc_rate=rate)
    del base, pick, db, dc, q, qi, head
    torch.cuda.empty_cache()
    return main


def kernel_phase(seed: int):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)

    def rand_keys(n, bits=32):
        halves = torch.randint(0, 2**bits, (n, 2), generator=g, device=dev,
                               dtype=torch.int64)
        return ((halves[:, 0] << 32) | halves[:, 1]) ^ SIGN

    # -- sorted_probe at PubChem scale ---------------------------------------
    keys = torch.sort(rand_keys(PUBCHEM)).values
    pick = torch.randint(0, PUBCHEM, (FROM_PLANE,), generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(QUERIES - FROM_PLANE)])
    qk = qk[torch.randperm(QUERIES, generator=g, device=dev)]
    main = probe_case("pubchem", keys, qk, reps=50, note="(1.42 GB plane)",
                      flush=flush)
    del keys, pick, qk

    # -- sorted_probe on 24-bit digests: duplicate runs -----------------------
    narrow = torch.randint(0, 1 << 24, (DUP_TABLE,), generator=g, device=dev)
    keys = torch.sort(narrow ^ SIGN).values  # hi = 0, lo = 24-bit digest
    runs = DUP_TABLE - int(torch.unique(keys).numel())
    if runs == 0:
        fail("24-bit table has no duplicate runs")
    pick = torch.randint(0, DUP_TABLE, (FROM_PLANE,), generator=g, device=dev)
    miss = torch.randint(0, 1 << 24, (QUERIES - FROM_PLANE,), generator=g,
                         device=dev) ^ SIGN
    qk = torch.cat([keys[pick], miss])
    probe_case("dup24", keys, qk, reps=50, note=f"({runs} duplicate entries)",
               flush=flush)
    del keys, narrow, pick, miss, qk

    # -- sorted_probe at a serving request's shape ----------------------------
    keys = torch.sort(rand_keys(SERVE_PLANE)).values
    pick = torch.randint(0, SERVE_PLANE, (SERVE_KEYS - SERVE_KEYS // 4,),
                         generator=g, device=dev)
    qk = torch.cat([keys[pick], rand_keys(SERVE_KEYS // 4)])
    probe_case("serving", keys, qk, reps=200, note="(a request's keys)", flush=flush,
               serving=True)
    del keys, pick, qk

    # -- hash_mix: the verify batch, the other widths, the funnel's batch,
    # and a slice 4 bytes off 16-byte alignment ------------------------------
    hm = hash_case("verify", random_u32(g, (VERIFY_ROWS, VERIFY_LANES), dev), 20, flush)
    for name, shape, reps in (("W=32", (VERIFY_ROWS, 32), 20),
                              ("W=64", (VERIFY_ROWS, 64), 20),
                              ("funnel", (FUNNEL_VERIFY_ROWS, VERIFY_LANES), 200)):
        err = hash_case(name, random_u32(g, shape, dev), reps, flush)["max_abs_err"]
        hm["max_abs_err"] = max(hm["max_abs_err"], err)
    flat = random_u32(g, (VERIFY_ROWS * VERIFY_LANES + 1,), dev)
    err = hash_case("unaligned", flat[1:].view(VERIFY_ROWS, VERIFY_LANES), 20,
                    flush)["max_abs_err"]
    hm["max_abs_err"] = max(hm["max_abs_err"], err)
    del flat, flush
    torch.cuda.empty_cache()
    return main, hm


def attention_case(case, seed: int):
    """Hold flash_attention's kernel to its plain version in bfloat16 on
    the model's (B, S, H, D) layout viewed as (B, H, S, D); time it, the
    plain version and scaled_dot_product_attention, and read SDPA's output
    under the same bounds."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, route
    from repro_torch.kernels.flash_attention.ref import bound_excess, flash_attention_ref

    name, b, hq, hkv, s, d, window = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)

    def make(h):
        x = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
        return x.transpose(1, 2)

    q, k, v = make(hq), make(hkv), make(hkv)
    path = route(q, k, v)
    if path != "tensor_core":
        fail(f"flash_attention {name}: the serving layout took the {path} route")
    mask = None
    if window is not None:
        i = torch.arange(s, device=dev)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

    def sdpa():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    out = flash_attention_cuda(q, k, v, causal=True, window=window).float()
    qf, kf, vf = q.float(), k.float(), v.float()
    ref = flash_attention_ref(qf, kf, vf, causal=True, window=window)
    abs_v = flash_attention_ref(qf, kf, vf.abs(), causal=True, window=window)
    err, ratio = float((out - ref).abs().max()), bound_excess(out, ref, abs_v)
    cut = (slice(None), slice(None), slice(FA_DROP, None))
    lost = flash_attention_ref(qf[cut], kf[cut], vf[cut], causal=True, window=window)
    wrong = bound_excess(lost, ref[cut], abs_v[cut])
    lib = sdpa().float()
    lib_derived, lib_cast = bound_excess(lib, ref, abs_v), bound_excess(lib, ref)
    same = float((lib == out).float().mean())
    tol = (f"route {path}, bound |err| <= 2^-8|ref| + 2^-8 A(|v|) + 1e-4: worst "
           f"{ratio:.4g} of it (output-cast-only bound: "
           f"{bound_excess(out, ref):.4g}); losing keys 0..{FA_DROP - 1} reads "
           f"{wrong:.4g}; sdpa reads {lib_derived:.4g} (cast-only {lib_cast:.4g}) "
           f"and equals the kernel's output at {same:.4f} of the elements")
    if not ratio <= 1.0:
        fail(f"flash_attention {name}: max_abs_err {err} outside the bound ({tol})")
    if not wrong > 1.0:
        fail(f"flash_attention {name}: the bound passes a wrong variant ({tol})")
    del out, ref, abs_v, lost, lib, qf, kf, vf
    before = flash_attention_cuda.tc_launches
    ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True,
                                              window=window), 20, warmup=2)
    if flash_attention_cuda.tc_launches - before != 22:
        fail(f"flash_attention {name}: timed launches left the tensor-core route")
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True,
                                                window=window), 2, warmup=1)
    library = cuda_ms(sdpa, 20, warmup=2)
    # the visible (query, key) pairs of this mask, two products of D each
    w = s if window is None else window
    pairs = sum(min(p + 1, w) for p in range(s))
    flops = 4 * b * hq * d * pairs
    nbytes = 2 * b * s * d * (2 * hq + 2 * hkv)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"flash_attention[{name}]: B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
          f"window={window} bf16 causal max_abs_err={err:.6g} ({tol}); "
          f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms(sdpa)={library:.6f} "
          f"flops={flops} bytes={nbytes} bound_ms={bnd:.6f} ({by}) "
          f"tflops={flops / ms / 1e9:.1f}", flush=True)
    del q, k, v, mask
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=library, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


# sources whose kernels must not spill, and what each redesigned kernel's
# SASS must hold: (source, kernel, opcodes)
NO_SPILL_SOURCES = ("flash_attention", "sorted_probe", "hash_mix")
DESIGN_OPCODES = (
    ("flash_attention", "fa_forward_tc", ("HGMMA", "UTMALDG")),  # wgmma, TMA
    ("hash_mix", "hash_mix_staged_kernel", ("LDGSTS",)),         # cp.async
)


def build_checks(build) -> None:
    """The built libraries: ptxas reports no spills in any kernel of
    ``NO_SPILL_SOURCES``, and each redesigned kernel's instruction is in
    its SASS (``DESIGN_OPCODES``)."""
    import re

    for source in NO_SPILL_SOURCES:
        report = build.ptxas_report(source)
        spills = [m.group(0) for m in re.finditer(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
            if m.group(1) != "0" or m.group(2) != "0"]
        if spills or "spill" not in report:
            fail(f"{source}: ptxas reports spills (or no report): {spills}")
        print(f"ptxas[{source}]: no spills", flush=True)
    for source, kernel, opcodes in DESIGN_OPCODES:
        ops = build.sass_opcode_counts(build.sass(source), kernel, opcodes)
        print(f"sass[{source}, {kernel}]: {json.dumps(ops)}", flush=True)
        if not all(ops.values()):
            fail(f"{source}: the SASS of {kernel} lacks {ops}")


def ssd_scan_case(case, seed: int):
    """Hold ssd_scan's kernel to its plain version on the card, bit for bit
    (both multiply, then add, in float32); time both."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    name, bh, c, p, n = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 5)
    states = torch.randn((bh, c, p, n), generator=g, device=dev)
    decay = torch.rand((bh, c), generator=g, device=dev)   # uniform in [0, 1)
    got = ssd_scan_cuda(states, decay)
    want = ssd_scan_ref(states, decay)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"ssd_scan {name}: kernel disagrees with plain version ({bad} outputs)")
    err = float((got - want).abs().max())
    del got, want
    ms = cuda_ms(lambda: ssd_scan_cuda(states, decay), 20)
    plain = cuda_ms(lambda: ssd_scan_ref(states, decay), 3, warmup=1)
    nbytes = 2 * states.numel() * 4 + decay.numel() * 4
    flops = 2 * states.numel()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    bnd, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    print(f"ssd_scan[{name}]: BH={bh} C={c} P={p} N={n} f32 bit-exact; "
          f"kernel_ms={ms:.6f} plain_ms={plain:.6f} library_ms=null (no PyTorch "
          f"call computes this scan) bytes={nbytes} flops={flops} "
          f"bound_ms={bnd:.6f} ({by})", flush=True)
    del states, decay
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def corpus_prompts(work: Path, lengths) -> list:
    """Prompts cut from the funnel corpus's records: the i-th starts at the
    i-th record's id line and runs ``lengths[i]`` bytes (records are ASCII)."""
    from repro_torch.core.records import iter_records

    path = sorted((work / "corpus").glob("compound_*.sdf"))[0]
    recs = []
    for _, text in iter_records(path):
        recs.append(text)
        if len(recs) == 64:
            break
    stream = "".join(recs)
    out, at = [], 0
    for n, rec in zip(lengths, recs):
        start = stream.index("InChI=", at)
        out.append(stream[start:start + n])
        at += len(rec)
    if [len(p.encode()) for p in out] != list(lengths):
        fail("funnel corpus too short for the serving prompts")
    return out


def prompt_batch(prompts):
    """``(tokens (B, S) right-padded, lengths (B,))`` of BOS + the bytes of
    each prompt, as the engine pads them."""
    from repro_torch.data.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    ids = [tok.encode(p, add_eos=False) for p in prompts]
    toks = torch.full((len(ids), max(map(len, ids))), tok.pad_id, dtype=torch.long)
    for i, row in enumerate(ids):
        toks[i, :len(row)] = torch.tensor(row)
    return toks, torch.tensor([len(r) for r in ids])


def model_cases():
    """The model checks, in float32, as ``{phase: [(name, cfg, init,
    prefill, prompt bytes, kernel launches wanted), ...]}``: yi-6b and
    mamba2-1.3b at full width cut to ``MODEL_LAYERS`` layers, and jamba's
    smoke config (no hybrid config of the repo fits one card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.hybrid import _layout, hybrid_prefill, init_hybrid
    from repro_torch.models.ssm import init_ssm, ssm_prefill
    from repro_torch.models.transformer import init_lm, lm_prefill

    def cut(arch):
        return dataclasses.replace(get_config(arch), n_layers=MODEL_LAYERS,
                                   dtype="float32")

    jamba = dataclasses.replace(get_config("jamba-1.5-large-398b").smoke(),
                                dtype="float32")
    n_blocks, _, mamba_pos, _, _ = _layout(jamba)
    return {
        "dense": [("yi-6b full width, 2 layers", cut("yi-6b"), init_lm, lm_prefill,
                   (255, 97), {"flash_attention": MODEL_LAYERS})],
        "recurrent": [
            ("mamba2-1.3b full width, 2 layers", cut("mamba2-1.3b"), init_ssm,
             ssm_prefill, SSM_MODEL_LENGTHS, {"ssd_scan": MODEL_LAYERS}),
            ("jamba-1.5-large-398b smoke", jamba, init_hybrid, hybrid_prefill,
             SSM_MODEL_LENGTHS, {"flash_attention": n_blocks,
                                 "ssd_scan": n_blocks * len(mamba_pos)}),
        ],
    }


def model_phase(work: Path, seed: int, cases, wrappers) -> None:
    """For each case: weights made once on the CPU and copied to the card,
    prefill logits of two ragged corpus prompts on the card against the
    CPU's, in float32 with TF32 off, and the card's kernel launches
    (``wrappers``' counts) against the ones wanted."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name, cfg, init, prefill, lengths, want_launches in cases:
        t0 = time.perf_counter()
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        cpu_model = init(cfg, g, "cpu")
        card_model = copy.deepcopy(cpu_model).to("cuda")
        toks, lens = prompt_batch(corpus_prompts(work, lengths))
        want, _ = prefill(cpu_model, cfg, toks, lengths=lens)
        for fn in wrappers.values():
            fn.launches = 0
        got, cache = prefill(card_model, cfg, toks.cuda(), lengths=lens.cuda())
        torch.cuda.synchronize()
        launches = {n: fn.launches for n, fn in wrappers.items()}
        got = got.cpu()
        if got.shape != (2, cfg.vocab_size) or not torch.isfinite(got).all():
            fail(f"model check {name}: logits {tuple(got.shape)} not finite or "
                 "misshaped")
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, atol=MODEL_ATOL, rtol=MODEL_RTOL)
        print(f"model check: {name}, float32, allow_tf32=False; prompts "
              f"{lens.tolist()} tokens; card vs CPU prefill logits "
              f"max_abs_err={err:.6g} (atol {MODEL_ATOL}, rtol {MODEL_RTOL}); "
              f"launches {json.dumps(launches)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            fail(f"model check {name}: card logits differ from the CPU's (max {err})")
        for kernel, n in launches.items():
            if n != want_launches.get(kernel, 0):
                fail(f"model check {name}: {n} {kernel} launches, want "
                     f"{want_launches.get(kernel, 0)}")
        del cpu_model, card_model, cache, got
        torch.cuda.empty_cache()


def lm_serving_phase(work: Path, seed: int, arch: str, wrapper, card: str) -> int:
    """``arch`` at its published widths and full depth, bfloat16, through
    launch.serve.run; ``wrapper``'s kernel must launch exactly once per
    layer per prefill.  Returns its launches over the phase."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    name = wrapper.__name__.removesuffix("_cuda")
    prompts = corpus_prompts(work, SERVE_LENGTHS)
    args = serve.build_parser().parse_args([
        "--arch", arch, "--full-config", "--device", "cuda",
        "--seed", str(seed), "--max-new-tokens", str(SERVE_NEW_TOKENS),
        "--max-len", str(SERVE_MAX_LEN), "--repeats", "2", "--prompts", *prompts,
    ])
    torch.cuda.reset_peak_memory_stats()
    wrapper.launches = 0
    routed = hasattr(wrapper, "tc_launches")  # flash_attention: two routes
    if routed:
        wrapper.tc_launches = 0
    t0 = time.perf_counter()
    out = serve.run(args)
    launches = wrapper.launches
    tc_launches = wrapper.tc_launches if routed else None
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    runs = out["runs"]
    if runs[0]["token_ids"] != runs[1]["token_ids"]:
        fail(f"{arch} serving: the two generate calls gave different tokens")
    vocab = get_config(arch).vocab_size
    for row in runs[0]["token_ids"]:
        if not row or any(not 0 <= t < vocab for t in row):
            fail(f"{arch} serving: bad token row {row[:8]}")
    want = 2 * out["n_layers"]
    if launches != want:
        fail(f"{arch} serving: {launches} {name} launches, want {want} "
             f"(one per layer per prefill, none in decode)")
    if routed and tc_launches != want:
        fail(f"{arch} serving: {tc_launches} of {launches} {name} launches on "
             f"the tensor-core route, want all")
    for i, r in enumerate(runs):
        print(f"lm_serving[{arch}] run {i}: B={out['batch']} prompt tokens "
              f"{out['prompt_tokens']}; prefill_ms={r['prefill_ms']:.3f} "
              f"decode {r['decode_steps']} steps in {r['decode_ms']:.3f} ms = "
              f"{r['decode_tokens_per_s']:.1f} tokens/s; card: {card}", flush=True)
    print(f"lm_serving[{arch}]: {out['n_layers']} layers bf16, init "
          f"{out['init_s']:.1f} s, weight_bytes={out['weight_bytes']} "
          f"cache_bytes={out['kv_cache_bytes']} (summed over the cache prefill "
          f"allocated) peak_allocated={peak} (this phase); {name} launches "
          f"{launches} ({launches // 2} per prefill"
          f"{f', {tc_launches} on the tensor-core route' if routed else ''}); "
          f"tokens identical over 2 runs; {secs:.1f} s", flush=True)
    profile_generate(out.pop("engine"), prompts, card, arch)
    del out
    torch.cuda.empty_cache()
    return launches


def profile_generate(engine, prompts, card: str, arch: str) -> None:
    """Where serving's time goes: one more ``generate`` of the served engine
    under ``torch.profiler``.  For its ``Engine.prefill`` and
    ``Engine.decode`` spans: the span's wall time, the card's busy time in
    it (the device's kernels and copies that start inside the span; one
    stream, so they do not overlap) and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = ("Engine.prefill", "Engine.decode")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate(prompts)
    events = prof.events()
    spans = {e.name: e.time_range for e in events
             if e.name in names and e.device_type == DeviceType.CPU}
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.name not in names and not getattr(e, "is_user_annotation", False)]
    for name in names:
        span = spans.get(name)
        inside = [e for e in device if span and span.start <= e.time_range.start < span.end]
        if not inside:
            print(f"lm_profile[{arch}][{name}]: the profiler saw no device events in "
                  "it: busy share not measured", flush=True)
            continue
        wall = span.elapsed_us()
        busy = sum(e.time_range.elapsed_us() for e in inside)
        per_kernel: dict = {}
        for e in inside:
            t, n = per_kernel.get(e.name, (0, 0))
            per_kernel[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        tops = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:5]
        top = "; ".join(f"{k[:60]} {t / 1e3:.3f} ms x{n}" for k, (t, n) in tops)
        print(f"lm_profile[{arch}][{name}]: wall {wall / 1e3:.3f} ms under the profiler, "
              f"device busy {busy / 1e3:.3f} ms = {busy / wall:.3f} of it "
              f"({len(inside)} device events); top: {top}; card: {card}", flush=True)


def reset_launches(wrappers) -> None:
    """Set every launch count of ``wrappers`` (the total and each route's)
    to 0."""
    for fn in wrappers:
        for attr in list(vars(fn)):
            if attr.endswith("launches"):
                setattr(fn, attr, 0)


def route_launches(wrappers) -> dict:
    """``{name: {"launches": total, "<route>_launches": n, ...}}``."""
    return {name: {attr: getattr(fn, attr) for attr in sorted(vars(fn))
                   if attr.endswith("launches")}
            for name, fn in wrappers.items()}


def hashed_phase_check(work: Path, summary: dict, seed: int) -> None:
    """The funnel's hashed-key phase is deterministic: its mismatch count
    must equal ``HASHED_MISMATCHES`` (seed 0) and the count through an
    index built by one process on the same corpus, whose entries the
    funnel's pool build (``workers=4``) must equal."""
    from repro_torch.core import (
        IndexStore, RecordStore, build_index, extract, intersect_host)
    from repro_torch.core.sdfgen import db_id_list
    from repro_torch.launch.funnel import SHARDS, funnel_spec

    bits = summary["hashed_key_bits"]
    store = RecordStore(work / "corpus")
    one = build_index(store, key_mode="hashed_key", key_bits=bits,
                      recompute_keys=True, workers=1)
    pool = build_index(store, key_mode="hashed_key", key_bits=bits,
                       recompute_keys=True, workers=4)
    if list(one.entries.items()) != list(pool.entries.items()):
        fail("hashed-key index: workers=4 differs from workers=1")
    one.save_sharded(work / "hashed_one", n_shards=SHARDS)
    spec = funnel_spec(FUNNEL_RECORDS, seed)
    ids = intersect_host(db_id_list(spec, "chembl", extra_outside=30),
                         db_id_list(spec, "emolecules", extra_outside=30)).ids
    res = extract(store, IndexStore.open(work / "hashed_one", device="cuda"), ids,
                  key_bits=bits, device="cuda")
    got, one_count = summary["hashed_mismatches"], len(res.mismatches)
    pinned = HASHED_MISMATCHES if seed == 0 else None
    print(f"funnel {bits}-bit phase: {got} mismatches; workers=1 index on the "
          f"same corpus: {one_count}; pinned (seed 0): {pinned}", flush=True)
    if got != one_count or (pinned is not None and got != pinned):
        fail(f"{bits}-bit phase: {got} mismatches, workers=1 gives {one_count}, "
             f"pinned {pinned}")


def serving_phase(serve_index, work: Path, wrappers, card: str):
    """The query service on the funnel's corpus and store, lookup mode then
    similarity mode; returns each kernel's launches over the phase."""
    common = ["--store", str(work / "store"), "--corpus", str(work / "corpus"),
              "--device", "cuda", "--replicas", "2", "--clients", "8",
              "--seconds", "2"]
    reset_launches(wrappers.values())
    t0 = time.perf_counter()
    look = serve_index.run(serve_index.build_parser().parse_args(common))
    sim = serve_index.run(serve_index.build_parser().parse_args(
        common + ["--similarity", "--similar-k", "8"]))
    counts = route_launches(wrappers)
    launches = {n: c["launches"] for n, c in counts.items()}
    print(f"serving phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{json.dumps(counts)}", flush=True)
    for mode, out in (("lookup", look), ("similarity", sim)):
        if not out.get("parity"):
            fail(f"serve_index {mode} mode ran no parity gate")
        for arm in ("service", "naive"):
            r = out[arm]
            if r["errors"]:
                fail(f"serve_index {mode} {arm}: {r['errors']} requests raised")
            unit = "lookups/s" if mode == "lookup" else "similarity queries/s"
            print(f"serve_index[{mode}] {arm}: {r['per_s']:.1f} {unit}, "
                  f"p50 {r['p50_ms']:.3f} ms, p99 {r['p99_ms']:.3f} ms, "
                  f"{r['requests']} requests; card: {card}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} was not launched in the serving phase")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one card")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    try:
        from repro_torch.kernels import build
        from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
        from repro_torch.kernels.hash_mix.kernel import hash_mix_cuda
        from repro_torch.kernels.sorted_probe.kernel import sorted_probe_cuda
        from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda
        from repro_torch.kernels.tanimoto.kernel import tanimoto_topk_cuda
        from repro_torch.launch import serve_index
        from repro_torch.launch.funnel import run_funnel
    except ImportError as e:
        fail(f"the port's package is not beside this script ({e})")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    secs = build.build()
    print(f"build: {len(build.SOURCES)} sources in {secs:.1f} s", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "smem" in line):
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
    build_checks(build)

    t0 = time.perf_counter()
    probe, hm = kernel_phase(args.seed)
    tani = tanimoto_phase(args.seed)
    attn = attention_case(FA_YI, args.seed)
    attention_case(FA_GEMMA, args.seed)
    ssd = ssd_scan_case(SSD_PREFILL, args.seed)
    ssd_scan_case(SSD_LONG, args.seed)
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s", flush=True)

    wrappers = {"sorted_probe": sorted_probe_cuda, "hash_mix": hash_mix_cuda,
                "tanimoto": tanimoto_topk_cuda}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        reset_launches(wrappers.values())
        summary = run_funnel(FUNNEL_RECORDS, seed=args.seed, device="cuda",
                             log=lambda s: print(f"funnel: {s}", flush=True),
                             workdir=work)
        funnel_launches = route_launches(
            {n: wrappers[n] for n in ("sorted_probe", "hash_mix")})
        print(f"funnel summary: {json.dumps(summary)}", flush=True)
        for name, counts in funnel_launches.items():
            if counts["launches"] == 0:
                fail(f"{name} was not launched on the funnel's path")
        print(f"funnel launches: {json.dumps(funnel_launches)}", flush=True)
        hashed_phase_check(Path(work), summary, args.seed)

        launches = serving_phase(serve_index, Path(work), wrappers, card)
        t0 = time.perf_counter()
        checks = model_cases()
        lm_wrappers = {"flash_attention": flash_attention_cuda,
                       "ssd_scan": ssd_scan_cuda}
        model_phase(Path(work), args.seed, checks["dense"], lm_wrappers)
        launches["flash_attention"] = lm_serving_phase(
            Path(work), args.seed, "yi-6b", flash_attention_cuda, card)
        print(f"LM phases: {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        model_phase(Path(work), args.seed, checks["recurrent"], lm_wrappers)
        launches["ssd_scan"] = lm_serving_phase(
            Path(work), args.seed, "mamba2-1.3b", ssd_scan_cuda, card)
        print(f"SSM phases: {time.perf_counter() - t0:.1f} s", flush=True)

    kernels = [
        dict(name="sorted_probe", route="cuda",
             source="src/repro_torch/csrc/sorted_probe.cu",
             replaces="src/repro/kernels/sorted_probe/kernel.py:53",
             launches=launches["sorted_probe"], **probe),
        dict(name="hash_mix", route="cuda",
             source="src/repro_torch/csrc/hash_mix.cu",
             replaces="src/repro/kernels/hash_mix/kernel.py:65",
             launches=launches["hash_mix"], **hm),
        dict(name="tanimoto", route="cuda",
             source="src/repro_torch/csrc/tanimoto.cu",
             replaces="src/repro/kernels/tanimoto/kernel.py:135",
             launches=launches["tanimoto"], **tani),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:97",
             launches=launches["flash_attention"], **attn),
        dict(name="ssd_scan", route="cuda",
             source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:36",
             launches=launches["ssd_scan"], **ssd),
    ]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in kernels]}))
    print(f"nvidia-smi: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
