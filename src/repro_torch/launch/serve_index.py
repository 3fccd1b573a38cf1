"""Index-serving launcher: ``python -m repro_torch.launch.serve_index …``.

Stands up the full query-service stack — ShardRouter replicas over a
published sharded store, the continuous micro-batching scheduler, the
pipelined reader with the shared scan-resistant record cache — and
drives it with a closed-loop load, reporting sustained lookups/sec,
p50/p99 latency, coalesced batch sizes, and cache/Bloom counters, plus
the naive per-key baseline for comparison.

    # demo corpus + store, 8 clients x 4-key requests, 2 replicas
    python -m repro_torch.launch.serve_index --records 24000 --clients 8

    # serve an existing store (built with ByteOffsetIndex.save_sharded)
    python -m repro_torch.launch.serve_index --store runs/index_store \\
        --corpus runs/corpus --replicas 4 --max-batch 512 --max-wait-ms 1

``--device`` (default ``cuda``) is where the stores probe and scan and
the verifier compares digests: on ``cuda`` the lookups run the
``sorted_probe`` kernel, ``fetch`` verification the ``hash_mix`` kernel and
similarity the ``tanimoto`` kernel; ``--device cpu`` runs their plain
PyTorch versions on the host.

    python -m repro_torch.launch.serve_index --device cpu --records 4000 --similarity

``--skip-naive`` drops the baseline pass; ``--keys-per-request 1``
measures the pure request-coalescing regime (each client request is a
single key, so the entire win must come from cross-client batching).

``--similarity`` switches the load to the second query modality: each
client request is a batch of query fingerprints answered with
``QueryService.similar`` (batched Tanimoto top-``--similar-k`` over the
store's fingerprint planes, coalesced across clients), against a naive
one-query-at-a-time baseline, with a parity gate asserting the service
path matches per-query scoring exactly.

``--chaos`` wraps every replica endpoint in a seeded
:class:`~repro_torch.service.transport.FaultInjectingTransport` and drives the
closed-loop load through injected faults: a shard killed on every
replica mid-run (``--chaos-kill-shard`` / ``--chaos-kill-at``), revived
later (``--chaos-revive-at``), optional per-shard latency spikes
(``--chaos-latency-shard`` / ``--chaos-latency-ms``) and transient error
rates (``--chaos-flaky-rate``).  The report separates failed vs degraded
requests, shows hedges fired / retries / per-shard error taxonomy, and
gates on full post-revival parity against a clean store.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from repro_torch.core import IndexStore, RecordStore, build_index, extract
from repro_torch.core.fingerprint import fingerprint_batch
from repro_torch.core.sdfgen import CorpusSpec, generate_corpus
from repro_torch.device import resolve_device
from repro_torch.runtime.fault import BackoffPolicy
from repro_torch.service import (
    FaultInjectingTransport,
    LocalTransport,
    QueryService,
    ServiceConfig,
    ShardRouter,
    run_closed_loop,
)

# places distros drop tcmalloc; probed in order, first hit wins
_TCMALLOC_CANDIDATES = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/aarch64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
)


def _maybe_preload_tcmalloc() -> None:
    """Re-exec under tcmalloc when the library is present.

    The span engine's carve/decode path allocates from several threads at
    once; glibc malloc's arena locking shows up as serving jitter there.
    tcmalloc's thread-local caches remove it.  Opt out with
    ``REPRO_NO_TCMALLOC=1``; the ``_REPRO_TCMALLOC`` guard keeps the
    re-exec from recursing, and boxes without the library run as-is.
    """
    if os.environ.get("REPRO_NO_TCMALLOC") or os.environ.get("_REPRO_TCMALLOC"):
        return
    if "tcmalloc" in os.environ.get("LD_PRELOAD", ""):
        return
    for so in _TCMALLOC_CANDIDATES:
        if os.path.exists(so):
            env = dict(os.environ)
            env["LD_PRELOAD"] = ":".join(
                p for p in (env.get("LD_PRELOAD", ""), so) if p
            )
            env["_REPRO_TCMALLOC"] = "1"
            os.execve(sys.executable, [sys.executable] + sys.argv, env)


def _demo_store(records: int, files: int, n_shards: int):
    """Generate a demo corpus + published store under a temp dir."""
    spec = CorpusSpec(n_files=files, records_per_file=records // files)
    root = Path(tempfile.mkdtemp(prefix="serve_index_")) / "corpus"
    generate_corpus(root, spec)
    rstore = RecordStore(root)
    idx = build_index(rstore, key_mode="full_id")
    store_dir = root.parent / "index_store"
    idx.save_sharded(store_dir, n_shards=n_shards)
    return rstore, store_dir, spec


def _report(rep) -> Dict[str, float]:
    """The numbers of one closed-loop arm, for the run's summary."""
    return {
        "per_s": rep.lookups_per_sec,
        "requests": rep.requests,
        "p50_ms": rep.p50_ms,
        "p99_ms": rep.p99_ms,
        "errors": rep.errors,
        "degraded": rep.degraded,
    }


def _similarity_load(svc, store_dir, keys, args) -> Dict[str, object]:
    """The ``--similarity`` closed-loop: batched Tanimoto vs per-query naive."""
    bits = svc.router.fingerprint_bits
    if bits is None:
        raise SystemExit(
            "store has no fingerprint plane — republish with "
            "save_sharded(fingerprint_bits=...) to serve similarity"
        )
    k = args.similar_k
    print(f"similarity mode: {bits}-bit fingerprints, top-{k} per query")
    fps, _ = fingerprint_batch(keys, bits)
    pool = list(fps)
    out: Dict[str, object] = {"mode": "similarity", "k": k}

    if not args.skip_parity:
        sample = fps[:: max(1, len(fps) // 64)][:64]
        svc_out = svc.similar(sample, k)
        ref_store = IndexStore.open(store_dir, device=args.device)
        naive_out = [
            ref_store.similar_batch(sample[i:i + 1], k, probe="host")
            for i in range(len(sample))
        ]
        for col in range(3):
            merged = np.concatenate([p[col] for p in naive_out], axis=0)
            assert np.array_equal(svc_out[col], merged), (
                "similarity parity failure: coalesced service results "
                "differ from per-query scoring"
            )
        print(f"parity: svc.similar == per-query similar_batch on "
              f"{len(sample)} queries ✓")
        out["parity"] = len(sample)

    if not args.skip_naive:
        naive_store = IndexStore.open(store_dir, device=args.device)
        naive_store.similar_batch(fps[:1], k, probe="host")  # warm planes

        def naive(rows):  # pre-batching contract: one scan per query
            for r in rows:
                naive_store.similar_batch(
                    np.asarray(r)[None, :], k, probe="host"
                )

        rep_naive = run_closed_loop(
            naive, pool, clients=args.clients, duration_s=args.seconds,
            keys_per_request=args.keys_per_request,
        )
        print(f"naive  : {rep_naive.summary()}")
        out["naive"] = _report(rep_naive)

    svc.similar(fps[: min(64, len(pool))], k)  # warm planes + batcher
    rep_svc = run_closed_loop(
        lambda rows: svc.similar(np.stack(rows), k), pool,
        clients=args.clients, duration_s=args.seconds,
        keys_per_request=args.keys_per_request,
    )
    print(f"service: {rep_svc.summary()}")
    out["service"] = _report(rep_svc)
    if not args.skip_naive:
        print(f"speedup: {rep_svc.lookups_per_sec / max(rep_naive.lookups_per_sec, 1e-9):.2f}x "
              f"sustained similarity queries/s vs naive per-query scans")

    sim = svc.stats()["similarity"]
    sched = sim["scheduler"] or {}
    print(f"similarity: {sim['batches']} router batches / "
          f"{sim['queries']} queries ({sim['scattered']} scattered, "
          f"{sim['inline']} inline, {sim['shard_probes']} shard probes), "
          f"{sim['fp_rows_scanned'] / 1e6:.1f}M row-pairs scored")
    if sched:
        print(f"scheduler: {sched['batches']} probes / "
              f"{sched['requests']} requests, mean batch "
              f"{sched['mean_batch_keys']:.1f} queries; latency "
              f"p50={sched['latency_ms']['p50']:.2f}ms "
              f"p99={sched['latency_ms']['p99']:.2f}ms")
    out["stats"] = sim
    return out


def _chaos_load(svc, injectors, store_dir, keys, args) -> Dict[str, object]:
    """The ``--chaos`` closed-loop: injected faults under live load.

    The invariants this run demonstrates (and asserts):

    * clients see ZERO exceptions — a dead shard range degrades, it does
      not fail the request;
    * degraded responses carry the per-key ``degraded`` mask, so callers
      can distinguish "absent" from "unknown";
    * after the revive point, full parity with a clean store returns
      within the recovery window (health probation + backoff).
    """
    rt = svc.router
    print(
        f"chaos: seed {args.chaos_seed}; kill shard {args.chaos_kill_shard} "
        f"on every replica at t+{args.chaos_kill_at:.1f}s, revive at "
        f"t+{args.chaos_revive_at:.1f}s"
        + (f"; +{args.chaos_latency_ms:.0f}ms latency on shard "
           f"{args.chaos_latency_shard}"
           if args.chaos_latency_shard is not None else "")
        + (f"; flaky rate {args.chaos_flaky_rate:.0%}"
           if args.chaos_flaky_rate > 0 else "")
    )
    if args.chaos_latency_shard is not None:
        for tr in injectors:
            tr.set_latency(
                args.chaos_latency_ms,
                jitter_ms=args.chaos_latency_ms / 3,
                shard=args.chaos_latency_shard,
            )
    if args.chaos_flaky_rate > 0:
        for tr in injectors:
            tr.set_error_rate(args.chaos_flaky_rate)

    svc.lookup_batch(keys[: min(2000, len(keys))])  # warm

    events = []

    def schedule():
        t0 = time.perf_counter()
        time.sleep(args.chaos_kill_at)
        for tr in injectors:
            tr.kill(shard=args.chaos_kill_shard)
        events.append(("kill", time.perf_counter() - t0))
        time.sleep(max(0.0, args.chaos_revive_at - args.chaos_kill_at))
        for tr in injectors:
            tr.revive(shard=args.chaos_kill_shard)
        events.append(("revive", time.perf_counter() - t0))

    th = threading.Thread(target=schedule, daemon=True)
    th.start()
    rep = run_closed_loop(
        lambda ks: svc.lookup_batch(ks), keys,
        clients=args.clients, duration_s=args.seconds,
        keys_per_request=args.keys_per_request,
        classify=lambda r: bool(r.degraded.any()),
        counters_fn=lambda: {
            "hedges_fired": rt.stats.hedges_fired,
            "hedge_wins": rt.stats.hedge_wins,
            "retries": rt.stats.retries,
            "probes_failed": rt.stats.probes_failed,
            "degraded_keys": rt.stats.degraded_keys,
        },
    )
    th.join(timeout=args.chaos_revive_at + 10)
    print(f"service: {rep.summary()}")
    c = rep.counters
    print(
        f"chaos:   {rep.errors} failed / {rep.degraded} degraded of "
        f"{rep.requests} requests; hedges {c.get('hedges_fired', 0)} "
        f"(won {c.get('hedge_wins', 0)}), retries {c.get('retries', 0)}, "
        f"probes failed {c.get('probes_failed', 0)}, degraded keys "
        f"{c.get('degraded_keys', 0)}"
    )
    errs = rt.stats.errors_per_shard
    if errs:
        print("chaos:   error taxonomy per shard: "
              + ", ".join(f"s{s}={dict(e)}" for s, e in sorted(errs.items())))
    assert rep.errors == 0, (
        f"{rep.errors} requests raised to clients — degraded mode must "
        f"return partial results, not exceptions"
    )

    # recovery gate: full parity with a clean store within the window
    sample = keys[:: max(1, len(keys) // 500)]
    ref = IndexStore.open(store_dir, device=args.device)
    want = ref.lookup_batch(sample)
    t_revive = time.perf_counter()
    deadline = t_revive + args.chaos_recovery_s
    got = svc.lookup_batch(sample)
    while got.degraded.any() and time.perf_counter() < deadline:
        time.sleep(0.2)
        got = svc.lookup_batch(sample)
    recovered_in = time.perf_counter() - t_revive
    assert not got.degraded.any(), (
        f"degraded responses persisted {args.chaos_recovery_s:.0f}s after "
        f"revival"
    )
    for a, b in zip((got.file_ids, got.offsets, got.hit), want):
        assert np.array_equal(a, b), "post-revival results differ from clean store"
    snap = rt.health.snapshot()
    print(
        f"chaos:   post-revival parity on {len(sample)} keys ✓ "
        f"(re-probed clean {recovered_in:.2f}s after revive; "
        f"{snap['revivals']} domain revivals, last recovery "
        f"{snap['last_recovery_s']:.2f}s)"
    )
    return {"mode": "chaos", "service": _report(rep), "parity": len(sample),
            "recovered_in_s": recovered_in}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--store", help="published store dir (save_sharded)")
    ap.add_argument("--corpus", help="SDF corpus dir backing --store")
    ap.add_argument("--records", type=int, default=24_000,
                    help="demo corpus size when --store is omitted")
    ap.add_argument("--files", type=int, default=6)
    ap.add_argument("--shards", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="where the stores probe and scan and the verifier "
                         "compares digests: cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--max-wait-ms", type=float, default=1.0)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--keys-per-request", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--skip-naive", action="store_true")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--similarity", action="store_true",
                    help="drive the Tanimoto similarity modality instead "
                         "of exact-key lookups")
    ap.add_argument("--similar-k", type=int, default=8,
                    help="top-k per similarity query (--similarity mode)")
    ap.add_argument("--chaos", action="store_true",
                    help="wrap replicas in fault-injecting transports and "
                         "drive the load through a kill/revive cycle")
    ap.add_argument("--chaos-kill-shard", type=int, default=0,
                    help="shard hard-downed on every replica mid-run")
    ap.add_argument("--chaos-kill-at", type=float, default=0.5,
                    help="seconds into the run when the shard dies")
    ap.add_argument("--chaos-revive-at", type=float, default=1.2,
                    help="seconds into the run when the shard revives")
    ap.add_argument("--chaos-latency-shard", type=int, default=None,
                    help="shard given an injected latency spike from t0")
    ap.add_argument("--chaos-latency-ms", type=float, default=30.0)
    ap.add_argument("--chaos-flaky-rate", type=float, default=0.0,
                    help="transient per-probe error rate on every shard")
    ap.add_argument("--chaos-seed", type=int, default=42)
    ap.add_argument("--chaos-recovery-s", type=float, default=10.0,
                    help="post-revival window in which full parity must "
                         "return")
    ap.add_argument("--reader-backend", default=None,
                    choices=["auto", "uring", "thread", "mmap", "serial"],
                    help="span I/O backend (default: REPRO_READER_BACKEND "
                         "env or auto)")
    ap.add_argument("--reader-depth", type=int, default=None,
                    help="max in-flight spans per file read "
                         "(default: REPRO_READER_DEPTH env or 32)")
    return ap


def run(args: argparse.Namespace) -> Dict[str, object]:
    """Serve and drive one store as ``args`` says (see :func:`build_parser`);
    returns the run's summary.  Raises on a failed parity gate."""
    resolve_device(args.device)  # before any corpus is generated
    if args.store:
        store_dir = Path(args.store)
        rstore = RecordStore(Path(args.corpus)) if args.corpus else None
    else:
        print(f"no --store given: generating a {args.records}-record demo "
              f"corpus ({args.files} files, {args.shards} shards)…")
        rstore, store_dir, _ = _demo_store(
            args.records, args.files, args.shards
        )

    cfg = ServiceConfig(
        device=args.device,
        replicas=args.replicas,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        reader_backend=args.reader_backend,
        reader_depth=args.reader_depth,
        similar_top_k=max(32, args.similar_k),
    )
    injectors = []
    if args.chaos:
        # chaos serving posture: wrap each replica endpoint, keep probe
        # deadlines tight and the dead-replica backoff short so the
        # kill/revive cycle resolves inside the run window
        def chaos_factory(st, i):
            tr = FaultInjectingTransport(
                LocalTransport(st, name=f"replica{i}"),
                seed=args.chaos_seed + i,
            )
            injectors.append(tr)
            return tr

        router = ShardRouter(
            store_dir,
            replicas=args.replicas,
            device=args.device,
            min_scatter_keys=cfg.min_scatter_keys,
            transport_factory=chaos_factory,
            probe_timeout_ms=250.0,
            fail_threshold=2,
            health_backoff=BackoffPolicy(base_s=0.2, cap_s=1.0),
        )
        svc = QueryService(rstore, router, cfg)
    else:
        svc = QueryService(rstore, store_dir, cfg)
    keys = sorted(svc.router.iter_keys())
    print(f"store: {len(svc):,} entries, {svc.router.n_shards} shards, "
          f"{args.replicas} replicas; load: {args.clients} closed-loop "
          f"clients x {args.keys_per_request} keys/request")

    if args.similarity:
        try:
            return _similarity_load(svc, store_dir, keys, args)
        finally:
            svc.close()

    if args.chaos:
        try:
            return _chaos_load(svc, injectors, store_dir, keys, args)
        finally:
            svc.close()
            router.close()  # chaos router is launcher-owned, not service-owned

    try:
        return _lookup_load(svc, rstore, store_dir, keys, args)
    finally:
        svc.close()


def _lookup_load(svc, rstore, store_dir, keys, args) -> Dict[str, object]:
    """The default closed-loop: coalesced lookups vs per-key naive."""
    out: Dict[str, object] = {"mode": "lookup"}

    # parity gate: the service path must be byte-identical to the serial
    # reference before any throughput number means anything
    if rstore is not None and not args.skip_parity:
        sample = keys[:: max(1, len(keys) // 2000)]
        ref_idx = IndexStore.open(store_dir, device=args.device)
        serial = extract(rstore, ref_idx, sample, workers=0,
                         device=args.device)
        res = svc.fetch(sample)
        assert list(res.records.items()) == list(serial.records.items())
        assert res.missing == serial.missing
        assert res.mismatches == serial.mismatches
        print(f"parity: svc.fetch == serial extract on {len(sample)} "
              f"targets ✓")
        out["parity"] = len(sample)

    if not args.skip_naive:
        naive_store = IndexStore.open(store_dir, device=args.device)
        naive_store.lookup_batch(keys[: min(2000, len(keys))])  # warm

        def naive(ks):  # the pre-service contract: one probe per key
            for k in ks:
                naive_store.lookup_batch([k])

        rep_naive = run_closed_loop(
            naive, keys, clients=args.clients, duration_s=args.seconds,
            keys_per_request=args.keys_per_request,
        )
        print(f"naive  : {rep_naive.summary()}")
        out["naive"] = _report(rep_naive)

    svc.lookup_batch(keys[: min(2000, len(keys))])  # warm
    rep_svc = run_closed_loop(
        lambda ks: svc.lookup_batch(ks), keys, clients=args.clients,
        duration_s=args.seconds, keys_per_request=args.keys_per_request,
    )
    print(f"service: {rep_svc.summary()}")
    out["service"] = _report(rep_svc)
    if not args.skip_naive:
        print(f"speedup: {rep_svc.lookups_per_sec / max(rep_naive.lookups_per_sec, 1e-9):.2f}x "
              f"sustained lookups/s vs naive per-key probing")

    s = svc.stats()
    sch, cache, st = s["scheduler"], s["cache"], s["store"]
    print(f"scheduler: {sch['batches']} probes / {sch['requests']} requests, "
          f"mean batch {sch['mean_batch_keys']:.1f} keys (max "
          f"{sch['batch_keys_max']}), flushes full={sch['full_flushes']} "
          f"cohort={sch['cohort_flushes']} deadline={sch['deadline_flushes']} "
          f"immediate={sch['immediate_flushes']}")
    print(f"store: {st['bloom_rejects']} bloom rejects, "
          f"{st['verify_collisions']} digest collisions verified away, "
          f"{st['shards_touched']}/{svc.router.n_shards} shards touched")
    print(f"cache: {cache['hit_rate']:.0%} hit rate, "
          f"{cache['protected']} protected / {cache['probation']} probation "
          f"entries")
    rd = s["read"]
    print(f"read: backend={rd['backend']}, {rd['spans_read']} spans / "
          f"{rd['bytes_read'] / 1e6:.2f} MB for {rd['records']} records "
          f"(depth peak {rd['inflight_peak']}, {rd['cache_hits']} cache "
          f"hits); verify {rd['verify_records']} recs in "
          f"{rd['verify_batches']} batches (max {rd['verify_batch_max']})")
    out["stats"] = s
    return out


def main(argv: Optional[list] = None) -> None:
    args = build_parser().parse_args(argv)
    # the re-exec restarts the interpreter, so only the command line takes
    # it; callers of run() in a process of their own keep their allocator
    _maybe_preload_tcmalloc()
    run(args)


if __name__ == "__main__":
    main()
