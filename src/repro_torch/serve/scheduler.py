"""Token-level continuous batching over the paged KV cache, the port's
counterpart of the reference's ``serve/scheduler.py``.

The static :class:`~repro_torch.serve.engine.Engine` pads a batch, prefills
it once and decodes until its LAST sequence finishes.  This engine
decouples a sequence's lifetime from the batch's:

* **Paged KV cache.**  Each slot's cache rows live in fixed-size blocks of
  one preallocated pool per layer (:mod:`repro_torch.serve.kvcache`),
  addressed through a per-slot block table.  Admitting or evicting a
  sequence edits the table and never reshapes device state; the decode
  step always runs ``max_slots`` lanes.
* **Slot admission, EOS eviction.**  Between decode steps the leader admits
  queued requests into free slots (reserve-at-admission: a request gets
  every block it can touch or stays queued, so pool exhaustion is
  backpressure) and evicts finished sequences, whose blocks return to the
  free list.
* **Leader-combining decode loop.**  There is no engine thread: the
  submitting thread that finds no leader becomes the leader and runs
  admit → decode → evict for everyone until no work remains; arrivals
  during a step join at the next step boundary.  All device work runs on
  the leader, one thread at a time.
* **Prefix-cache sharing.**  Admission probes a
  :class:`~repro_torch.serve.kvcache.PrefixIndex` of rolling hashes of
  full token blocks: on a hit the slot adopts the resident blocks
  (refcount bump, no prefill for those tokens) and prefills only the
  suffix through ``prefill_suffix`` (``lm_prefill_suffix``).  Every
  admitted prompt publishes its full blocks; under pool pressure the
  index LRU-evicts entries whose blocks nothing else holds.  Sharing is
  off for MoE (capacity drops depend on the prefill's batch shape) and
  VLM (image tokens offset every position), as in the reference.

Where the reference jits its steps and donates the cache, the paged
functions update the pool tensors in place, and the decode step
(``decode_step_paged`` and the next token of every lane, greedy or
sampled) runs as the static engine's does (``ContinuousEngine(...,
decode=)``): ``"graph"``, the default on a CUDA engine, captures it once
per capture key (``max_slots``, the block-table width,
``flags.DECODE_CHUNKED``) as one ``torch.cuda.CUDAGraph`` over static lane
buffers (tokens, positions, block tables, the sampled path's seeds and
token indices, next tokens) and replays it; ``"static"`` runs the same
step op by op; ``"eager"`` uploads fresh tensors each step.  The host
copies the lanes in before each step (the block tables only when they
changed) and reads the ``(max_slots,)`` next tokens back after it; the
emit/evict bookkeeping stays on the host.  The warm-up before a capture
runs over zeroed lanes, whose writes land in the trash block.

Emission matches the static engine's greedy path: the first token is the
argmax of the prefill logits at the true last prompt position, decode
feeds token *k* at position ``len + k - 1``, and a sequence stops after
EOS or ``max_new_tokens`` tokens.  With ``greedy=False`` token *k* of a
request (the first at *k* = 0) is the reference's draw: the logits cast
to float32 and divided by the temperature, cut to ``ServeConfig.top_k``,
then ``categorical`` under the key ``fold_in(prng_key(seed), k)`` of the
request's uint32 seed, through :func:`repro_torch.kernels.sample.ops.sample`
(the CUDA kernel on the card, which derives each lane's key itself).  So a
request's samples depend on its prompt and seed only, never on its lane or
on what else is batched, and they are ``jax.random``'s bit for bit up to
the last ulp of a ``log`` (:mod:`repro_torch.serve.sampling`).

Per-request SLO accounting records time to first token (submit → first
token) and inter-token latency (consecutive decode steps) in bounded
windows; ``slo_ms()`` reports p50/p99 of both.  Each request's
``GenerationResult`` also carries ``queue_s`` (host seconds from
``submit`` to the start of the admission attempt that admitted it, its
prefix probe included: under one-at-a-time admission, the wait that batched
admission would cut).

Spans (:func:`repro_torch.runtime.trace.span`: a
``torch.profiler.record_function`` while a profiler runs, a shared null
context costing under 1 us otherwise), all on the leader's thread:
``ContinuousEngine.prefix_match`` (each prefix probe, before the
admission's prefill span); ``ContinuousEngine.prefill`` (one admission)
and inside it ``ContinuousEngine.prefill.model`` (the prompt tensors built
and uploaded, and the ``prefill`` or ``prefill_suffix`` call),
``ContinuousEngine.prefill.first_token`` (the first token's draw and its
read back), ``ContinuousEngine.prefill.cache_write`` (the table row's
upload and ``paged_prefill_write``) and ``ContinuousEngine.prefix_publish``
(each ``PrefixIndex.publish``); ``ContinuousEngine.decode`` (one step) and
inside it ``ContinuousEngine.decode.lanes_in`` (the lanes copied in),
``ContinuousEngine.decode.replay`` (the graph replay, or the step op by
op) and ``ContinuousEngine.decode.readback`` (the ``(max_slots,)`` next
tokens read back); then ``ContinuousEngine.emit`` (the emit/evict loop,
with the callbacks of the futures it resolves).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from .. import flags
from ..configs.base import ModelConfig
from ..data.tokenizer import ByteTokenizer
from ..device import DeviceLike, resolve_device
from ..kernels.sample.ops import sample
from ..models.registry import build_model
from ..runtime.trace import span
from .engine import GenerationResult, ServeConfig
from .kvcache import BlockManager, PagedCacheSpec, PrefixIndex, blocks_for

__all__ = ["ContinuousEngine", "ContinuousStats", "EngineClosed"]


class EngineClosed(RuntimeError):
    """The engine is closed; the request was or will never be admitted."""


# Bounded windows for TTFT / inter-token latency percentiles.
_SLO_WINDOW = 8192


@dataclasses.dataclass
class ContinuousStats:
    """Cumulative scheduler counters (allocator stats live on the manager)."""

    requests: int = 0
    completed: int = 0
    failed: int = 0             # futures resolved with an exception
    cancelled: int = 0          # queued requests cancelled at close()
    prefills: int = 0
    steps: int = 0              # batched decode steps executed
    tokens_out: int = 0         # tokens emitted across all requests
    decode_tokens: int = 0      # tokens emitted by decode steps (excl. first)
    admission_stalls: int = 0   # head-of-queue blocked on slots or blocks
    peak_active: int = 0
    prefix_hits: int = 0        # admissions that adopted indexed blocks
    prefix_misses: int = 0      # prefix-eligible admissions with no match
    prefill_tokens_saved: int = 0  # prompt tokens whose prefill was skipped

    @property
    def tokens_per_step(self) -> float:
        """Mean kept tokens per decode step (≤ max_slots; lane occupancy)."""
        return self.decode_tokens / self.steps if self.steps else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        probes = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / probes if probes else 0.0


class _Seq:
    """Host-side state of one admitted sequence (leader-thread only)."""

    __slots__ = (
        "future", "prompt_len", "budget", "tokens", "t_submit",
        "prefill_s", "t_first", "t_last", "fed", "queue_s",
    )

    def __init__(self, future, prompt_len, budget, t_submit, prefill_s, now,
                 queue_s):
        self.future: "Future[GenerationResult]" = future
        self.prompt_len = prompt_len
        self.budget = budget
        self.tokens: List[int] = []
        self.t_submit = t_submit
        self.prefill_s = prefill_s
        self.t_first = now
        self.t_last = now
        self.fed = 0            # decode steps this sequence was fed into
        self.queue_s = queue_s


class _Request:
    __slots__ = ("prompt", "budget", "future", "t_submit", "seed")

    def __init__(self, prompt: List[int], budget: int, seed: int = 0):
        self.prompt = prompt
        self.budget = budget
        self.seed = seed
        self.future: "Future[GenerationResult]" = Future()
        self.t_submit = time.perf_counter()


class ContinuousEngine:
    """``submit(text) -> Future`` serving over a paged pool of decode slots,
    for ``model`` (whose parameters must already be on ``device``).

    Greedy by default; with ``greedy=False`` each request samples under
    its own keys, ``fold_in(prng_key(seed), token index)``.
    ``generate(texts)`` is a thin batch wrapper: enqueue all, lead once,
    gather in order.  ``decode`` picks how a decode step runs (see the
    module notes): ``"graph"``, ``"static"`` or ``"eager"``; None takes
    ``"graph"`` on a CUDA engine, else ``"eager"``.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        model: torch.nn.Module,
        spec: PagedCacheSpec,
        scfg: ServeConfig = ServeConfig(),
        prefix_cache: bool = True,
        device: DeviceLike = "cuda",
        mesh=None,
        decode: Optional[str] = None,
    ):
        if mesh is not None:
            raise ValueError("the continuous engine serves on one device and "
                             "takes no mesh (serve a mesh with the static Engine)")
        self.cfg = cfg
        self.api = build_model(cfg)
        if not self.api.supports_paged:
            raise ValueError(
                f"model family {cfg.family!r} (windows="
                f"{getattr(cfg, 'window', None)}) has no paged-KV decode "
                "path; use the static Engine"
            )
        self.device = resolve_device(device)
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters are on {p.device}, the engine on "
                    f"{self.device}"
                )
        if decode is None:
            decode = "graph" if self.device.type == "cuda" else "eager"
        if decode not in ("graph", "static", "eager"):
            raise ValueError(f"decode={decode!r}: one of graph, static, eager")
        if decode == "graph" and self.device.type != "cuda":
            raise ValueError(f"decode='graph' needs a CUDA engine, not {self.device}")
        self.decode = decode
        self.model = model
        self.spec = spec
        self.scfg = scfg
        self.tok = ByteTokenizer()
        self.stats = ContinuousStats()
        self._offset = cfg.n_img_tokens or 0

        self._mgr = BlockManager(spec)
        self._cache = self.api.paged_cache_init(spec.n_blocks, spec.block_size,
                                                self.device)

        # Prefix sharing needs reproducible prefill: MoE capacity routing
        # depends on the prefill batch shape (suffix vs full give different
        # drops), and VLM image tokens offset every position — bypass both.
        self._prefix_enabled = bool(
            prefix_cache
            and self.api.prefill_suffix is not None
            and self._offset == 0
            and cfg.family != "moe"
        )
        self._index: Optional[PrefixIndex] = (
            PrefixIndex(self._mgr) if self._prefix_enabled else None
        )
        self._temp = float(max(scfg.temperature, 1e-6))
        self._top_k = int(scfg.top_k)

        # Leader-only decode state (no lock: exactly one leader at a time);
        # each lane's sampling seed and the index of its next token
        self._cur = np.zeros((spec.max_slots, 1), np.int64)
        self._pos = np.zeros((spec.max_slots,), np.int64)
        self._seeds = np.zeros((spec.max_slots,), np.uint32)
        self._idx = np.zeros((spec.max_slots,), np.uint32)
        self._active: Dict[int, _Seq] = {}
        self._free_slots: List[int] = list(range(spec.max_slots - 1, -1, -1))
        self._tables_dev = self._upload(self._mgr.tables)
        self._tables_dirty = False
        # static lanes of the step ("graph" and "static"), and the captured
        # step and its key
        lanes = spec.max_slots
        self._lane_cur = torch.zeros((lanes, 1), dtype=torch.long, device=self.device)
        self._lane_pos = torch.zeros((lanes,), dtype=torch.long, device=self.device)
        self._lane_seed = torch.zeros((lanes,), dtype=torch.int32, device=self.device)
        self._lane_idx = torch.zeros((lanes,), dtype=torch.int32, device=self.device)
        self._lane_next = torch.zeros((lanes,), dtype=torch.long, device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._graph_key: Optional[tuple] = None
        self.captures = 0          # CUDA graphs captured
        self.replays = 0           # CUDA graph replays (decode steps)
        self.capture_s = 0.0       # host seconds of the last capture, warm-up included

        self._lock = threading.Lock()      # queue, stop flag, SLO windows
        self._leader = threading.Lock()    # at most one decode loop
        self._queue: Deque[_Request] = deque()
        self._stop = False
        self._ttft_ms: Deque[float] = deque(maxlen=_SLO_WINDOW)
        self._itl_ms: Deque[float] = deque(maxlen=_SLO_WINDOW)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(self.device)

    def _upload_u32(self, a: np.ndarray) -> torch.Tensor:
        """uint32 values as the int32 tensor of their bits."""
        return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)).to(
            self.device)

    # -- client surface ------------------------------------------------------

    def submit(
        self,
        text: str,
        max_new_tokens: Optional[int] = None,
        lead: bool = True,
        seed: Optional[int] = None,
    ) -> "Future[GenerationResult]":
        """Enqueue one prompt; the future resolves to a GenerationResult.

        The calling thread may become the leader and run the decode loop
        for every queued and active request until no work remains
        (``lead=False`` only enqueues — ``generate`` uses it to stage a
        batch before leading once).

        ``seed`` keys this request's sampling (``greedy=False``); when
        omitted it derives from ``scfg.seed`` and the submission ordinal —
        pass it explicitly when replaying a workload across threads, where
        submission order is not deterministic.
        """
        budget = max_new_tokens or self.scfg.max_new_tokens
        req = _Request(self.tok.encode(text, add_eos=False), budget)
        total = self._offset + len(req.prompt) + budget - 1
        if budget < 1:
            req.future.set_exception(ValueError("max_new_tokens must be >= 1"))
            return req.future
        if total > self.spec.max_len:
            req.future.set_exception(
                ValueError(
                    f"prompt+budget needs {total} cache rows > max_len "
                    f"{self.spec.max_len} "
                    f"({self.spec.max_blocks_per_seq} blocks × "
                    f"{self.spec.block_size})"
                )
            )
            return req.future
        with self._lock:
            if self._stop:
                raise EngineClosed("engine is closed")
            self.stats.requests += 1
            req.seed = seed if seed is not None else (
                self.scfg.seed + self.stats.requests
            )
            self._queue.append(req)
        if lead:
            self._maybe_lead()
        return req.future

    def generate(
        self, texts: List[str], max_new_tokens: Optional[int] = None
    ) -> List[GenerationResult]:
        """Batch wrapper: enqueue everything, lead once, gather in order."""
        futs = [self.submit(t, max_new_tokens, lead=False) for t in texts]
        self._maybe_lead()
        return [f.result() for f in futs]

    # -- leader-combining decode loop ----------------------------------------

    def _maybe_lead(self) -> None:
        # Non-blocking: if a leader exists it admits our request at its next
        # step boundary.  The re-check loop closes the race where the old
        # leader saw an empty queue and was releasing as we enqueued.
        while True:
            with self._lock:
                work = bool(self._queue) and not self._stop
            if not work or not self._leader.acquire(blocking=False):
                return
            try:
                self._run_loop()
            finally:
                self._leader.release()

    def _run_loop(self) -> None:
        """Admit → decode one token for every active slot → evict; repeat.

        Runs on the submitting thread that won leadership.  An exception
        (out of memory, a failed launch) is delivered to every *active*
        future — a dying leader must not strand callers — then swallowed
        so it cannot tear down an unrelated client thread; queued requests
        stay queued for the next leader.
        """
        try:
            with torch.no_grad():
                while True:
                    self._admit()
                    if not self._active:
                        with self._lock:
                            if not self._queue or self._stop:
                                return
                        continue  # backpressure cleared by an eviction race
                    self._decode_once()
        except BaseException as e:  # noqa: BLE001 — delivered, then re-raised if fatal
            for slot, seq in list(self._active.items()):
                if not seq.future.done():
                    seq.future.set_exception(e)
                self.stats.failed += 1
                self._mgr.release(slot)
                self._free_slots.append(slot)
            self._active.clear()
            self._tables_dirty = True
            if isinstance(e, (SystemExit, KeyboardInterrupt)):
                raise

    def _probe(self, prompt: List[int]):
        """Longest indexed block-aligned prefix → (blocks, n_tokens)."""
        if self._index is None:
            return [], 0
        with span("ContinuousEngine.prefix_match"):
            return self._index.match(prompt)

    def _admit(self) -> None:
        """Move queued requests into free slots, strictly FIFO.

        Head-of-line blocking is deliberate: skipping a big request to
        admit later small ones would starve it under sustained load.
        Under pool pressure the prefix index gives blocks back (LRU entries
        whose blocks nothing else holds) before the head request stalls or
        fails — index residency is a cache, never a reservation.
        """
        while self._free_slots:
            with self._lock:
                if self._stop or not self._queue:
                    return
                req = self._queue[0]
            total = self._offset + len(req.prompt) + req.budget - 1
            t_admit = time.perf_counter()
            # leader-only state below (index, allocator): the lock above
            # only guards the queue — nobody else pops it
            adopt, start = self._probe(req.prompt)
            if not self._mgr.can_admit(total, n_adopted=len(adopt)):
                if self._index is not None:
                    shortfall = (
                        blocks_for(total, self.spec.block_size)
                        - len(adopt) - self._mgr.n_free
                    )
                    if shortfall > 0 and self._index.evict_for(shortfall):
                        # eviction may have dropped the matched entry (or
                        # unlocked a shorter one): probe again
                        adopt, start = self._probe(req.prompt)
                if not self._mgr.can_admit(total, n_adopted=len(adopt)):
                    if self._active:
                        # an eviction will free blocks: wait at the head
                        self.stats.admission_stalls += 1
                        return
                    # the leader is the sole allocator and the index has
                    # given back what it can, so an idle pool is a full
                    # pool: this request can never fit
                    with self._lock:
                        if self._stop:
                            return  # close() already failed the queue
                        self._queue.popleft()
                        self.stats.failed += 1
                    req.future.set_exception(
                        RuntimeError(
                            f"request needs {blocks_for(total, self.spec.block_size)} "
                            f"blocks but the pool only has "
                            f"{self.spec.usable_blocks} usable"
                        )
                    )
                    continue
            with self._lock:
                if self._stop:
                    return
                self._queue.popleft()
            if not req.future.set_running_or_notify_cancel():
                with self._lock:
                    self.stats.cancelled += 1
                continue
            try:
                with span("ContinuousEngine.prefill"):
                    self._admit_one(req, total, adopt, start, t_admit - req.t_submit)
            except BaseException as e:
                # the request is off the queue and not yet active: fail it
                # here, then let the loop deliver to the active ones
                if not req.future.done():
                    req.future.set_exception(e)
                    self.stats.failed += 1
                raise
        # no free slot for the head request: wait for an eviction

    def _admit_one(
        self, req: _Request, total: int, adopt: List[int], start: int,
        queue_s: float,
    ) -> None:
        prompt, budget = req.prompt, req.budget
        n = len(prompt)
        bs = self.spec.block_size
        dev = self.device
        # Prompts pad to a block-size multiple; the dense cache is always
        # max_len rows (what the paged write scatters).  Pad rows beyond
        # ``lengths`` are overwritten by decode before any read sees them.
        bucket = min(self.spec.max_len - self._offset, blocks_for(n, bs) * bs)
        t0 = time.perf_counter()
        slot: Optional[int] = None
        if start > 0:
            # Prefix hit: the slot and its blocks come first (the suffix
            # prefill writes through the block table), then only the
            # unmatched tail runs the model.
            slot = self._free_slots.pop()
            if not self._mgr.admit(slot, total, prefix_blocks=adopt):
                raise RuntimeError("can_admit passed but admit failed")
            with span("ContinuousEngine.prefill.model"):
                suf = np.full((1, bucket - start), self.tok.pad_id, np.int64)
                suf[0, : n - start] = prompt[start:]
                row = self._upload(self._mgr.tables[slot])
                logits, self._cache = self.api.prefill_suffix(
                    self.model, self._upload(suf), start, row, self._cache, bs,
                    lengths=self._upload(np.array([n - start])),
                )
            dense = None
            self.stats.prefix_hits += 1
            self.stats.prefill_tokens_saved += start
        else:
            if self._prefix_enabled:
                self.stats.prefix_misses += 1
            with span("ContinuousEngine.prefill.model"):
                toks = np.full((1, bucket), self.tok.pad_id, np.int64)
                toks[0, :n] = prompt
                batch: Dict[str, Any] = {
                    "tokens": self._upload(toks),
                    "lengths": self._upload(np.array([n])),
                }
                if self.cfg.family == "vlm":  # the vision frontend is a stub
                    batch["patch_embeds"] = torch.zeros(
                        (1, self.cfg.n_img_tokens, self.cfg.d_model),
                        dtype=torch.float32, device=dev)
                logits, dense = self.api.prefill(self.model, batch,
                                                 max_len=self.spec.max_len)
        with span("ContinuousEngine.prefill.first_token"):
            first = self._first_token(logits[0], req.seed)
        now = time.perf_counter()
        prefill_s = now - t0
        self.stats.prefills += 1
        with self._lock:
            self._ttft_ms.append((now - req.t_submit) * 1e3)
        self.stats.tokens_out += 1

        if first == self.tok.eos_id or budget == 1:
            # Entirely served by prefill: occupies no slot past this point.
            # A prefix hit already owns blocks: publish the prompt's full
            # blocks (the suffix KV is resident and exact), then let go.
            if slot is not None:
                if self._index is not None:
                    with span("ContinuousEngine.prefix_publish"):
                        self._index.publish(prompt, self._mgr.slot_blocks(slot), n)
                self._mgr.release(slot)
                self._free_slots.append(slot)
                self._tables_dirty = True
            self.stats.completed += 1
            req.future.set_result(self._result([first], n, 0, prefill_s, 0.0,
                                               queue_s))
            return

        if slot is None:
            slot = self._free_slots.pop()
            if not self._mgr.admit(slot, total):
                raise RuntimeError("can_admit passed but admit failed")
            with span("ContinuousEngine.prefill.cache_write"):
                row = self._upload(self._mgr.tables[slot])
                self._cache = self.api.paged_prefill_write(self._cache, dense, row, bs)
        if self._index is not None:
            # publish every full-block prefix: decode writes land in the
            # partial/fresh tail blocks, never in published ones
            with span("ContinuousEngine.prefix_publish"):
                self._index.publish(prompt, self._mgr.slot_blocks(slot), n)
        seq = _Seq(req.future, n, budget, req.t_submit, prefill_s, now, queue_s)
        seq.tokens.append(first)
        self._cur[slot, 0] = first
        self._pos[slot] = self._offset + n
        self._seeds[slot] = req.seed & 0xFFFFFFFF
        self._idx[slot] = 1
        self._active[slot] = seq
        self._tables_dirty = True
        self.stats.peak_active = max(self.stats.peak_active, len(self._active))

    def _next(self, logits: torch.Tensor, seeds: Optional[torch.Tensor],
              index: Optional[torch.Tensor]) -> torch.Tensor:
        """The next token of each lane of ``(S, V)`` logits: the first
        maximal logit, or the reference's draw (float32, temperature,
        top-k) under the key ``fold_in(prng_key(seed), index)``."""
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1)
        return sample(logits, self._temp, seeds=seeds, index=index,
                      top_k=self._top_k, dtype=torch.float32)

    def _first_token(self, logits: torch.Tensor, seed: int) -> int:
        """First emitted token from the prefill logits (V,): greedy, or
        sampled at token index 0."""
        if self.scfg.greedy:
            return int(torch.argmax(logits))
        seeds = self._upload_u32(np.array([seed & 0xFFFFFFFF]))
        return int(self._next(logits[None], seeds, torch.zeros_like(seeds))[0])

    def _lane_step(self) -> None:
        """The step over the static lanes, every write in place: the step
        that a CUDA graph captures."""
        logits, _ = self.api.decode_step_paged(
            self.model, self._lane_cur, self._lane_pos, self._tables_dev,
            self._cache, self.spec.block_size)
        self._lane_next.copy_(self._next(logits, self._lane_seed, self._lane_idx))

    def _capture(self) -> None:
        """Capture :meth:`_lane_step` over zeroed lanes (position 0 of block
        0, the trash block), after a warm-up on a side stream.  Raises if
        the step cannot be captured."""
        t0 = time.perf_counter()
        for lane in (self._lane_cur, self._lane_pos, self._tables_dev,
                     self._lane_seed, self._lane_idx):
            lane.zero_()
        self._tables_dirty = True
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self._lane_step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # client threads only enqueue; the leader alone touches the device
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._lane_step()
        self._graph = graph
        self.capture_s = time.perf_counter() - t0
        self.captures += 1

    def _decode_lanes(self) -> np.ndarray:
        """One step over the static lanes → (S,) next tokens."""
        key = (self.spec.max_slots, self._tables_dev.shape[1], flags.DECODE_CHUNKED)
        if self.decode == "graph" and key != self._graph_key:
            self._capture()
            self._graph_key = key
        with span("ContinuousEngine.decode.lanes_in"):
            if self._tables_dirty:
                self._tables_dev.copy_(torch.from_numpy(self._mgr.tables))
                self._tables_dirty = False
            self._lane_cur.copy_(torch.from_numpy(self._cur))
            self._lane_pos.copy_(torch.from_numpy(self._pos))
            if not self.scfg.greedy:
                self._lane_seed.copy_(torch.from_numpy(self._seeds.view(np.int32)))
                self._lane_idx.copy_(torch.from_numpy(self._idx.view(np.int32)))
        with span("ContinuousEngine.decode.replay"):
            if self.decode == "graph":
                self._graph.replay()
                self.replays += 1
            else:
                self._lane_step()
        with span("ContinuousEngine.decode.readback"):
            return self._lane_next.cpu().numpy()  # the one host sync per step

    def _decode_eager(self) -> np.ndarray:
        """One step on fresh tensors → (S,) next tokens."""
        with span("ContinuousEngine.decode.lanes_in"):
            if self._tables_dirty:
                self._tables_dev = self._upload(self._mgr.tables)
                self._tables_dirty = False
            cur, pos = self._upload(self._cur), self._upload(self._pos)
            seeds = index = None
            if not self.scfg.greedy:
                seeds, index = self._upload_u32(self._seeds), self._upload_u32(self._idx)
        with span("ContinuousEngine.decode.replay"):
            logits, self._cache = self.api.decode_step_paged(
                self.model, cur, pos, self._tables_dev, self._cache,
                self.spec.block_size,
            )
            nxt = self._next(logits, seeds, index)
        with span("ContinuousEngine.decode.readback"):
            return nxt.cpu().numpy()  # the one host sync per step: (S,) token ids

    def _decode_once(self) -> None:
        """One batched paged decode step + host-side emit/evict."""
        with span("ContinuousEngine.decode"):
            nxt = self._decode_lanes() if self.decode != "eager" else self._decode_eager()
        now = time.perf_counter()
        self.stats.steps += 1
        with span("ContinuousEngine.emit"):
            for slot, seq in list(self._active.items()):
                tok = int(nxt[slot])
                seq.fed += 1
                seq.tokens.append(tok)
                with self._lock:
                    self._itl_ms.append((now - seq.t_last) * 1e3)
                seq.t_last = now
                self.stats.tokens_out += 1
                self.stats.decode_tokens += 1
                if tok == self.tok.eos_id or len(seq.tokens) >= seq.budget:
                    self._evict(slot, seq, now)
                else:
                    self._cur[slot, 0] = tok
                    self._pos[slot] += 1
                    self._idx[slot] = len(seq.tokens)

    def _evict(self, slot: int, seq: _Seq, now: float) -> None:
        self._mgr.release(slot)
        self._tables_dirty = True
        del self._active[slot]
        self._free_slots.append(slot)
        self._cur[slot, 0] = 0
        self._pos[slot] = 0
        self.stats.completed += 1
        seq.future.set_result(
            self._result(seq.tokens, seq.prompt_len, seq.fed, seq.prefill_s,
                         now - seq.t_first, seq.queue_s)
        )

    def _result(self, tokens, prompt_len, steps, prefill_s, decode_s, queue_s):
        return GenerationResult(
            text=self.tok.decode(tokens),
            token_ids=list(tokens),
            prompt_len=prompt_len,
            steps=steps,
            prefill_s=prefill_s,
            decode_s=decode_s,
            queue_s=queue_s,
        )

    # -- accounting ----------------------------------------------------------

    def slo_ms(self) -> Dict[str, float]:
        """TTFT and inter-token latency percentiles (bounded windows)."""
        with self._lock:
            ttft = list(self._ttft_ms)
            itl = list(self._itl_ms)

        def pct(xs: List[float], p: float) -> float:
            return float(np.percentile(xs, p)) if xs else 0.0

        return {
            "ttft_p50_ms": pct(ttft, 50),
            "ttft_p99_ms": pct(ttft, 99),
            "itl_p50_ms": pct(itl, 50),
            "itl_p99_ms": pct(itl, 99),
            "ttft_mean_ms": float(np.mean(ttft)) if ttft else 0.0,
            "itl_mean_ms": float(np.mean(itl)) if itl else 0.0,
        }

    def reset_slo(self) -> None:
        """Drop the SLO windows (exclude warm-up TTFT from a measurement)."""
        with self._lock:
            self._ttft_ms.clear()
            self._itl_ms.clear()

    def counters(self) -> Dict[str, float]:
        """Flat cumulative counters."""
        out = {k: float(v) for k, v in dataclasses.asdict(self.stats).items()}
        out["tokens_per_step"] = self.stats.tokens_per_step
        out["prefix_hit_rate"] = self.stats.prefix_hit_rate
        out.update({f"blk_{k}": float(v) for k, v in self._mgr.stats().items()})
        if self._index is not None:
            out.update(
                {f"pfx_{k}": float(v) for k, v in self._index.stats().items()}
            )
        return out

    def check(self) -> None:
        """Assert allocator + prefix-index consistency: every block's
        refcount equals its slot holds plus its index holds, exactly."""
        self._mgr.check(
            self._index.block_refs() if self._index is not None else None
        )

    # -- shutdown ------------------------------------------------------------

    def close(self, drain: bool = False) -> None:
        """Stop admitting; fail queued requests; wait out the leader.

        Queued-but-unadmitted futures resolve with :class:`EngineClosed`.
        Active sequences always finish their decode: the leader keeps
        decoding but admits nothing once the stop flag is up.  ``drain=True``
        first serves everything already queued (leading if necessary), so
        no request submitted before ``close`` is lost.
        """
        if drain:
            while True:
                with self._lock:
                    if self._stop or not self._queue:
                        break
                self._maybe_lead()
                with self._leader:
                    pass  # an existing leader is draining; wait it out
        with self._lock:
            if self._stop:
                return
            self._stop = True
            for req in self._queue:
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(
                        EngineClosed(
                            "engine is closed; request was queued but "
                            "never admitted"
                        )
                    )
                self.stats.cancelled += 1
            self._queue.clear()
        with self._leader:
            pass  # the leader drains its active set, then we own shutdown

    def __enter__(self) -> "ContinuousEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
