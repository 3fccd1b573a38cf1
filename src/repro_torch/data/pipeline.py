"""Index-backed training data pipeline.

The byte-offset index IS the dataset: examples are addressed
``example idx → record key → (file, byte_offset) → seek``.  Per step each
dp shard's fetches are **grouped by file and sorted by ascending offset**
— Algorithm 3's access-pattern optimization reapplied verbatim to the
training loader (DESIGN.md §2).

Production concerns implemented here:

* deterministic addressing (see :mod:`repro_torch.data.sampler`) — checkpoint =
  one integer, elastic re-shard for free;
* host-side prefetch thread (double buffering, overlap with device step);
* straggler mitigation: per-fetch deadline + speculative retry through a
  pluggable ``fetch_fn`` (any record is re-fetchable by any host because
  addressing is stateless — in a multi-host deployment the retry can go to
  a replica filesystem path);
* integrity: extracted records are id-verified (the paper's defensive
  validation) before tokenization; verification failures are surfaced,
  never silently dropped.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.cache import RecordCache
from ..core.extract import plan_extraction
from ..core.identifiers import canonical_id_from_structure
from ..core.iobackend import resolve_backend
from ..core.reader import (
    DEFAULT_COALESCE_GAP,
    DEFAULT_SPAN_GUESS,
    ReadStats,
    stream_plan,
)
from ..core.records import RecordStore, read_record_at
from ..device import DeviceLike, resolve_device
from ..runtime.trace import span
from .sampler import GlobalSampler
from .tokenizer import ByteTokenizer, render_example

__all__ = ["IndexedDataset", "BatchLoader", "StragglerStats"]


@dataclass
class StragglerStats:
    fetches: int = 0
    retries: int = 0
    deadline_misses: int = 0
    verify_failures: int = 0


class IndexedDataset:
    """Record-level access through the byte-offset index.

    Fetches ride the pipelined extraction engine
    (:mod:`repro_torch.core.reader`): a step's record set coalesces into merged
    preads per file, files fan out over ``workers`` threads, and an
    optional :class:`~repro_torch.core.cache.RecordCache` (``cache=`` or
    ``cache_records > 0``) serves epoch-loop repeats without re-reading or
    re-verifying.  Caching is opt-in because a cached record is served
    as-verified — a corpus mutated underneath the loader would go
    unnoticed until eviction.  ``workers=0`` falls back to the serial
    per-record loop.  ``reader_backend``/``reader_depth`` select and
    window the span I/O backend (uring/thread/mmap — see
    :mod:`repro_torch.core.iobackend`); the backend handle is owned by the
    dataset, opened lazily on the first engine fetch, and released by
    :meth:`close`.

    ``device`` (default ``"cuda"``, the port's policy) is where the batched
    verify of a step's records runs: on a CUDA device the recomputed ids
    are compared as ``hash_mix`` digests by the card's kernel
    (:mod:`repro_torch.core.verify`, ``auto`` backend), on the CPU as
    strings.  The serial loop (``workers=0``) compares strings on the host.

    ``service`` (a :class:`repro_torch.service.QueryService`) rides the shared
    query service instead of a private index handle: step fetches then
    coalesce with every other service caller (serving traffic, concurrent
    loaders) through the continuous-batching scheduler, and the service's
    scan-resistant record cache absorbs epoch repeats.  ``index`` may be
    ``None`` in that case; the dataset's own ``cache``/``workers`` knobs
    defer to the service's.
    """

    def __init__(
        self,
        store: RecordStore,
        index,  # ByteOffsetIndex | IndexStore (batch read contract) | None
        seq_len: int,
        verify: bool = True,
        workers: int = 2,
        cache: Optional[RecordCache] = None,
        cache_records: int = 0,
        coalesce_gap: int = DEFAULT_COALESCE_GAP,
        span_guess: int = DEFAULT_SPAN_GUESS,
        service=None,  # repro_torch.service.QueryService
        reader_backend: Optional[str] = None,
        reader_depth: Optional[int] = None,
        device: DeviceLike = "cuda",
    ):
        if index is None and service is None:
            raise ValueError("need an index or a QueryService")
        self.store = store
        self.index = index
        self.service = service
        self.seq_len = seq_len
        self.verify = verify
        self.workers = workers
        self.coalesce_gap = coalesce_gap
        self.span_guess = span_guess
        self.reader_backend = reader_backend
        self.reader_depth = reader_depth
        self.device = resolve_device(device)
        # span I/O backend is resolved lazily on the first engine fetch so
        # datasets that only ride the service (or only fetch_record) never
        # open a uring / spin up read state they won't use
        self._backend = None
        if service is not None:
            self.cache = service.cache
        else:
            self.cache = cache if cache is not None else (
                RecordCache(capacity=cache_records) if cache_records > 0 else None
            )
        self.tok = ByteTokenizer()
        # dataset order = sorted index keys (deterministic across hosts;
        # iter_keys is the enumeration every index backend shares)
        enum = index if index is not None else service.router
        self.keys: List[str] = sorted(enum.iter_keys())
        self.stats = StragglerStats()
        self.read_stats = ReadStats()
        # long-lived worker pool: fetch_many runs every training step, so
        # per-call pool construction would be pure hot-path overhead
        self._pool: Optional[ThreadPoolExecutor] = None

    def __len__(self) -> int:
        return len(self.keys)

    def fetch_record(self, key: str) -> str:
        if self.service is not None:
            loc = self.service.lookup([key])[0]
        else:
            loc = self.index.lookup(key)
        if loc is None:
            raise KeyError(key)
        fname, off = loc
        if self.cache is not None:
            hit = self.cache.get(fname, off)
            if hit is not None:
                p = hit[0]
                # the engine caches zero-copy RecordViews; decode at the
                # dataset's API boundary — callers get str, always
                return p if isinstance(p, str) else p.text
        text = read_record_at(self.store.path_of(fname), off)
        if self.cache is not None:
            self.cache.put(fname, off, text)
        return text

    def fetch_many(self, keys: List[str]) -> Dict[str, str]:
        """Grouped + offset-sorted fetch (Algorithm 3 access pattern).

        Planning goes through ONE batched index lookup (``plan_extraction``
        → ``locate_batch``), so a step's whole fetch set is digested,
        Bloom-filtered, and probed together when the index is a sharded
        ``IndexStore``; the read phase then streams through the pipelined
        engine (coalesced preads, parallel file workers, cached records).
        On the service path the same probe additionally coalesces with
        concurrent service callers before it reaches the router.
        """
        if self.service is not None:
            res = self.service.fetch(keys, verify=self.verify)
            if res.missing:
                raise KeyError(f"{len(res.missing)} keys missing from index")
            self.stats.fetches += res.seeks
            self.stats.verify_failures += len(res.mismatches)
            return res.records
        plan, missing = plan_extraction(self.index, keys)
        if missing:
            raise KeyError(f"{len(missing)} keys missing from index")
        out: Dict[str, str] = {}
        if self.workers > 0:
            if self.workers > 1 and self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=self.workers)
            if self._backend is None:
                self._backend = resolve_backend(self.reader_backend)
            for ev in stream_plan(
                self.store,
                plan,
                verify=self.verify,
                workers=self.workers,
                coalesce_gap=self.coalesce_gap,
                span_guess=self.span_guess,
                cache=self.cache,
                stats=self.read_stats,
                executor=self._pool,
                backend=self._backend,
                depth=self.reader_depth,
                device=self.device,
            ):
                self.stats.fetches += 1
                if ev.ok:
                    out[ev.full_id] = ev.text
                else:
                    self.stats.verify_failures += 1
            return out
        for fname, items in plan.items():
            path = self.store.path_of(fname)
            with open(path, "rb") as fh:
                for full_id, _key, off in items:
                    text = read_record_at(fh, off)
                    self.stats.fetches += 1
                    if self.verify:
                        try:
                            rid = canonical_id_from_structure(text)
                        except ValueError:
                            rid = "<unparseable>"
                        if rid != full_id:
                            self.stats.verify_failures += 1
                            continue
                    out[full_id] = text
        return out

    def close(self) -> None:
        """Release the worker pool and the owned span I/O backend."""
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
        if self._backend is not None:
            self._backend.close()
            self._backend = None

    def example(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        key = self.keys[idx % len(self.keys)]
        text = render_example(self.fetch_record(key))
        if text is None:
            # property-less record: substitute the id-only rendering
            text = key
        ids = self.tok.encode(text)
        return self.tok.pad_to(ids, self.seq_len)

    def batch_for(
        self, sampler: GlobalSampler, step: int, dp_rank: int, n_dp: int
    ) -> Dict[str, np.ndarray]:
        idxs = sampler.example_ids(step, dp_rank, n_dp)
        keys = [self.keys[i % len(self.keys)] for i in idxs]
        with span("IndexedDataset.fetch"):
            records = self.fetch_many(keys)
        with span("IndexedDataset.tokenize"):
            toks, masks = [], []
            for k in keys:
                text = render_example(records[k]) if k in records else k
                if text is None:
                    text = k
                t, m = self.tok.pad_to(self.tok.encode(text), self.seq_len)
                toks.append(t)
                masks.append(m)
            return {
                "tokens": np.stack(toks),
                "loss_mask": np.stack(masks),
            }


class BatchLoader:
    """Prefetching loader with deadline-based speculative retry.

    ``fetch_fn(step) -> batch`` defaults to the dataset's grouped fetch;
    tests inject slow/flaky fetchers to exercise the straggler path.
    """

    def __init__(
        self,
        dataset: IndexedDataset,
        sampler: GlobalSampler,
        dp_rank: int = 0,
        n_dp: int = 1,
        prefetch: int = 2,
        deadline_s: float = 30.0,
        fetch_fn: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.dp_rank = dp_rank
        self.n_dp = n_dp
        self.deadline_s = deadline_s
        self.fetch_fn = fetch_fn or (
            lambda step: dataset.batch_for(sampler, step, dp_rank, n_dp)
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_step = 0
        self.stats = dataset.stats

    # -- prefetch thread ----------------------------------------------------

    def start(self, from_step: int = 0) -> None:
        self._next_step = from_step
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _fetch_with_deadline(self, step: int) -> Dict[str, np.ndarray]:
        """One fetch; on deadline miss, speculatively re-issue (stateless
        addressing makes the retry identical and side-effect free)."""
        result: Dict[str, object] = {}
        done = threading.Event()

        def run():
            try:
                result["batch"] = self.fetch_fn(step)
            except Exception as e:  # pragma: no cover
                result["err"] = e
            finally:
                done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        if not done.wait(self.deadline_s):
            self.stats.deadline_misses += 1
            self.stats.retries += 1
            # speculative retry; first finisher wins
            t2 = threading.Thread(target=run, daemon=True)
            t2.start()
            done.wait()
        if "err" in result:
            raise result["err"]  # type: ignore[misc]
        return result["batch"]  # type: ignore[return-value]

    def _worker(self) -> None:
        while not self._stop.is_set():
            step = self._next_step
            batch = self._fetch_with_deadline(step)
            self._next_step = step + 1
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.25)
                    break
                except queue.Full:
                    continue

    def get(self, timeout: float = 60.0) -> Tuple[int, Dict[str, np.ndarray]]:
        return self._q.get(timeout=timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- synchronous convenience --------------------------------------------

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        return self._fetch_with_deadline(step)
