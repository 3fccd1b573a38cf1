"""Device-to-host copy rates on one CUDA card's host, by method.

    python3 scripts/host_copy_rates.py

Copies one 12.9 GB float32 tensor (the size of one of jamba-1.5-large's
MoE weight stacks, 16 x 8,192 x 24,576) from the card to host memory: a
plain ``.cpu()``; ``copy_`` into a fresh ``torch.empty`` (whose pages are
first touched by the copy), into the same tensor again and into a zeroed
one; the same slices copied from 4 and 8 threads; into pinned memory
(its allocation timed apart); and through two pinned staging buffers of
256 MiB and 1 GiB in turns (``chip_smoke.cpu_copy``'s method), checked
equal at both ends.  Prints the card's name and power limit, then the
seconds and GB/s of each."""
import subprocess
import threading
import time

import torch

N = 16 * 8192 * 24576  # elements: one MoE weight stack of jamba, f32


def timed(name, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"{name}: {dt:.2f} s = {4 * N / dt / 1e9:.2f} GB/s", flush=True)
    return out


def threaded(src, dst, n_threads):
    chunks = torch.arange(N).tensor_split(n_threads)
    bounds = [(int(c[0]), int(c[-1]) + 1) for c in chunks]

    def work(lo, hi):
        dst[lo:hi].copy_(src[lo:hi])

    ts = [threading.Thread(target=work, args=b) for b in bounds]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return dst


def staged(src, dst, stage_elems, n_stages=2):
    stages = [torch.empty(stage_elems, dtype=src.dtype, pin_memory=True)
              for _ in range(n_stages)]
    stream = torch.cuda.Stream()
    events = [torch.cuda.Event() for _ in range(n_stages)]
    pending = [None] * n_stages
    i = 0
    for lo in range(0, N, stage_elems):
        hi = min(lo + stage_elems, N)
        j = i % n_stages
        if pending[j] is not None:
            events[j].synchronize()
            plo, phi = pending[j]
            dst[plo:phi].copy_(stages[j][:phi - plo])
        with torch.cuda.stream(stream):
            stages[j][:hi - lo].copy_(src[lo:hi], non_blocking=True)
            events[j].record(stream)
        pending[j] = (lo, hi)
        i += 1
    for j in range(n_stages):
        if pending[j] is not None:
            events[j].synchronize()
            plo, phi = pending[j]
            dst[plo:phi].copy_(stages[j][:phi - plo])
    return dst


def main():
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}; threads {torch.get_num_threads()}",
          flush=True)
    src = torch.randn(N, device="cuda")
    out = timed("pageable .cpu()", lambda: src.cpu())
    del out
    dst = timed("torch.empty (no touch)", lambda: torch.empty(N))
    timed("copy_ into an untouched torch.empty", lambda: dst.copy_(src))
    timed("copy_ again into the same (touched) tensor", lambda: dst.copy_(src))
    del dst
    dst = timed("torch.zeros (touched)", lambda: torch.zeros(N))
    timed("copy_ into the zeroed tensor", lambda: dst.copy_(src))
    del dst
    for n in (4, 8):
        dst = torch.empty(N)
        timed(f"{n} threads copy_ slices into an untouched torch.empty",
              lambda: threaded(src, dst, n))
        del dst
    pinned = timed("torch.empty(pin_memory=True)", lambda: torch.empty(N, pin_memory=True))
    timed("copy_ into pinned", lambda: pinned.copy_(src))
    del pinned
    for stage in (1 << 26, 1 << 28):
        dst = torch.empty(N)
        timed(f"staged through 2 pinned buffers of {4 * stage >> 20} MiB",
              lambda: staged(src, dst, stage))
        ok = torch.equal(dst[:1000], src[:1000].cpu()) and torch.equal(dst[-1000:],
                                                                      src[-1000:].cpu())
        print(f"  staged copy equal at both ends: {ok}", flush=True)
        del dst


if __name__ == "__main__":
    main()
