"""Static-batch serving engine of the port: prefill + decode over the
uniform model API (the reference's ``serve/engine.py``).

A batch of prompts is right-padded to a common length, prefilled once with
each sequence's true length (so its first token comes from its own last
prompt position, not a pad row), then decoded token by token with
per-sequence positions until EOS or the token budget.  The decode loop
keeps everything on the device: each step emits the current tokens into a
device-side buffer, updates the EOS flags and runs the decode step; the
host reads only the all-done flag every ``sync_every`` steps, and copies
the token buffer back once at the end.

Spans (:func:`repro_torch.runtime.trace.span`: a
``torch.profiler.record_function`` while a profiler runs, a shared null
context costing under 1 us otherwise), so that a profile of ``generate``
splits its device time and its idle gaps between host phases:
``Engine.inputs`` (tokenize, pad, upload), ``Engine.prefill``,
``Engine.decode.start`` (the capture key's static buffers, and the
prefill's cache copied into them), ``Engine.decode`` and inside it
``Engine.decode.replay`` (each step's launch: the graph replay, the static
step or the eager step) and ``Engine.decode.done_check`` (the all-done poll
every ``sync_every`` steps), then ``Engine.readback`` (the one copy of the
tokens to the host).  The static engine's ``GenerationResult`` leaves
``queue_s`` at its default.

Over a mesh (``Engine(..., mesh=, param_specs=)``) the engine serves a
copy of the model whose parameters are DTensors laid out by their logical
specs (``models.specs.param_specs``; replicated without specs), the
request batch goes over the mesh's data-parallel axes, the KV and
recurrent caches are laid out by their cache specs as soon as the prefill
makes them, and the prefill and every decode step run under
``dist.logical.use_mesh``.  Every rank runs ``generate`` on the same
texts and gets the same tokens.  The caller's model is left as it was.

Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so
on float32 weights it gives the reference's tokens.  Sampling keeps the
reference's key chain: each ``generate`` starts from ``prng_key(
ServeConfig.seed)`` (a ``(2,)`` uint32 key on the device), and each decode
step splits it, ``key, sub = split(key)``, and draws
``categorical(sub, logits / temperature)`` over the whole ``(B, V)`` batch
in the logits' dtype, through :func:`repro_torch.kernels.sample.ops.sample`
(the CUDA kernel on the card, which also writes the new key).  The draws
are ``jax.random``'s bit for bit up to the last ulp of a ``log``
(:mod:`repro_torch.serve.sampling`), so on float32 weights the sampled
tokens are the reference's too.  The first token is the prefill's argmax,
as the reference's is.  Over a mesh every rank draws from the whole
logits with the same key.

How a decode step runs (``Engine(..., decode=)``), the counterpart of the
reference's one jitted step with donated buffers:

* ``"graph"`` (the default on a CUDA engine without a mesh): the step
  (emit, EOS flags, ``api.decode_step``, the next token) is captured once
  per capture key as one ``torch.cuda.CUDAGraph`` over static buffers
  (:class:`_StaticDecode`) and replayed every step.  The key is the family,
  B, ``max_len``, the token budget, greedy or sampled,
  ``flags.DECODE_CHUNKED`` as read at capture, and the cache's shapes.
  Each ``generate`` copies its prefill's cache into the static one (every
  row, so nothing of an earlier request or of the warm-up survives) and
  its first key into the static key; the warm-up before a capture runs on
  a side stream over zeroed buffers.  A sampled step reads and advances
  the static key on the device, so the graph holds no generator and reads
  nothing back.  A capture that fails raises.
* ``"static"``: the same static-buffer step, run op by op (what the graph
  replays, checkable on the CPU).
* ``"eager"`` (the default on the CPU and over a mesh): the step as
  PyTorch ops on fresh tensors each step.  A step of a model under
  ``models.moe.monitor`` runs eagerly whatever the mode (the monitor
  appends Python records).

``captures`` and ``replays`` count graph captures and replays.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from .. import flags
from ..configs.base import ModelConfig
from ..data.tokenizer import ByteTokenizer
from ..device import DeviceLike, resolve_device
from ..dist.logical import use_mesh, whole
from ..kernels.sample.ops import sample
from ..launch.sharding import (
    batch_shardings,
    distribute,
    distribute_params,
    module_copy,
    redistribute_tree,
    shardings_from_specs,
)
from ..models.moe import monitored
from ..models.registry import build_model
from ..models.specs import cache_specs
from ..runtime.trace import span
from .sampling import prng_key

__all__ = ["Engine", "GenerationResult", "ServeConfig"]


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_len: int = 512
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0              # 0 = no top-k cut (read by the continuous sampler)
    seed: int = 0
    # the host polls the all-done flag every ``sync_every`` decode steps
    # (1 = every step); the token buffer transfers once per generate
    sync_every: int = 8


@dataclasses.dataclass
class GenerationResult:
    text: str
    token_ids: List[int]
    prompt_len: int
    steps: int
    prefill_s: float
    decode_s: float
    # the continuous engine's record of the request: host seconds from
    # ``submit`` to the start of its admission
    queue_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.steps / self.decode_s if self.decode_s > 0 else float("inf")


def _copy_into(dst, src) -> None:
    """Copy every tensor of cache tree ``src`` into the same place of
    ``dst`` (a tensor already ``dst``'s, written in place, is left)."""
    for d, t in zip(tree_leaves(dst), tree_leaves(src)):
        if d is not t:
            d.copy_(t)


class _StaticDecode:
    """The buffers a captured decode step reads and writes, allocated once
    per capture key: the cache, the current tokens ``cur (B, 1)``, the
    positions ``pos (B,)``, the step index ``t (1,)``, the token buffer
    ``out_buf (B, n_new)``, the emitted counts ``n_emit (B,)``, the EOS
    flags ``done (B,)`` and the sampling key ``key (2,)`` uint32; ``graph``
    once captured."""

    def __init__(self, cache, b: int, n_new: int, pad_id: int):
        self.cache = tree_map(torch.zeros_like, cache)
        dev = tree_leaves(cache)[0].device
        self.cur = torch.zeros((b, 1), dtype=torch.long, device=dev)
        self.pos = torch.zeros((b,), dtype=torch.long, device=dev)
        self.t = torch.zeros((1,), dtype=torch.long, device=dev)
        self.out_buf = torch.full((b, n_new), pad_id, dtype=torch.long, device=dev)
        self.n_emit = torch.zeros((b,), dtype=torch.long, device=dev)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.key = torch.zeros((2,), dtype=torch.uint32, device=dev)
        self.pad_id = pad_id
        self.graph: Optional[torch.cuda.CUDAGraph] = None

    def start(self, cache, cur: torch.Tensor, pos: torch.Tensor,
              key: Optional[torch.Tensor]) -> None:
        """A new request batch: its prefill's cache, first tokens and (when
        it samples) key."""
        _copy_into(self.cache, cache)
        if key is not None:
            self.key.copy_(key)
        self.cur.copy_(cur)
        self.pos.copy_(pos)
        self.t.zero_()
        self.out_buf.fill_(self.pad_id)
        self.n_emit.zero_()
        self.done.zero_()


def _nbytes(tree) -> int:
    """Bytes of every tensor in a cache (whole tensors, summed over the
    ranks of a mesh): a list of per-layer dicts, or the encoder-decoder
    family's nested dict of stacked tensors."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return sum(map(_nbytes, tree.values() if isinstance(tree, dict) else tree))


class Engine:
    """Serves ``model`` (built by ``build_model(cfg).init`` or
    ``models.weights.params_from_reference``) on ``device``, where the
    model's parameters must already be.  ``decode`` picks how a decode step
    runs (see the module notes): ``"graph"``, ``"static"`` or ``"eager"``;
    None takes ``"graph"`` on a CUDA device without a mesh, else
    ``"eager"``."""

    def __init__(self, cfg: ModelConfig, model: torch.nn.Module,
                 scfg: ServeConfig = ServeConfig(), device: DeviceLike = "cuda",
                 mesh=None, param_specs: Optional[Mapping[str, Any]] = None,
                 decode: Optional[str] = None):
        self.cfg = cfg
        self.api = build_model(cfg)
        self.scfg = scfg
        self.device = resolve_device(device)
        if decode is None:
            decode = ("graph" if self.device.type == "cuda" and mesh is None
                      else "eager")
        if decode not in ("graph", "static", "eager"):
            raise ValueError(f"decode={decode!r}: one of graph, static, eager")
        if decode != "eager" and mesh is not None:
            raise ValueError("a decode step over a mesh runs eagerly (DTensor "
                             "dispatch): decode='eager'")
        if decode == "graph" and self.device.type != "cuda":
            raise ValueError(f"decode='graph' needs a CUDA engine, not {self.device}")
        self.decode = decode
        for p in model.parameters():
            if p.device.type != self.device.type:
                raise ValueError(
                    f"model parameters are on {p.device}, the engine on "
                    f"{self.device}"
                )
        self.mesh = mesh
        if mesh is not None:
            if mesh.device_type != self.device.type:
                raise ValueError(f"a {mesh.device_type} mesh for an engine on "
                                 f"{self.device}")
            model = distribute_params(module_copy(model), mesh, param_specs)
        self.model = model
        self.tok = ByteTokenizer()
        # bytes of the KV cache that the last ``generate``'s prefill allocated
        # (the encoder-decoder family's cross cache included)
        self.kv_cache_bytes = 0
        self._static: Dict[tuple, _StaticDecode] = {}
        self.captures = 0          # CUDA graphs captured
        self.replays = 0           # CUDA graph replays (decode steps)
        self.capture_s = 0.0       # host seconds of the last capture, warm-up included

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _shard_batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Spread the request batch over the mesh's data-parallel axes."""
        if self.mesh is None:
            return batch
        pls = batch_shardings(self.mesh, batch)
        return {k: distribute(v, self.mesh, pls[k]) for k, v in batch.items()}

    def _shard_cache(self, cache):
        """Lay the prefill's cache out by its cache specs (a no-op without
        a mesh), so that every ``constrain`` of the decode path meets a
        DTensor laid out as the reference lays its cache."""
        if self.mesh is None:
            return cache
        pls = shardings_from_specs(self.mesh, cache_specs(cache), cache)
        return redistribute_tree(cache, pls)

    def _pad_prompts(self, prompts: List[List[int]]) -> Tuple[np.ndarray, np.ndarray]:
        """Left-align prompts, pad right to the longest (positions differ)."""
        maxlen = max(len(p) for p in prompts)
        toks = np.full((len(prompts), maxlen), self.tok.pad_id, np.int64)
        lens = np.zeros((len(prompts),), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            lens[i] = len(p)
        return toks, lens

    def _step(self, cur, pos, cache, out_buf, n_emit, done, t, key):
        """Emit ``cur`` at column ``t``, update the EOS flags, decode one
        token: all on the device, no host transfer."""
        out_buf[:, t] = torch.where(done, self.tok.pad_id, cur[:, 0])
        n_emit += (~done).long()
        done |= cur[:, 0] == self.tok.eos_id
        logits, cache = self.api.decode_step(self.model, cur, pos, cache)
        return self._next(logits, key, cur[:, 0])[:, None], pos + 1, cache

    def _next(self, logits: torch.Tensor, key: Optional[torch.Tensor],
              like: torch.Tensor) -> torch.Tensor:
        """The next token of each row (B,), laid out as ``like``: the first
        maximal logit, or the reference's draw under ``split(key)[1]``,
        ``key`` advanced in place to ``split(key)[0]``."""
        if self.scfg.greedy:
            return torch.argmax(logits, dim=-1)
        tok = sample(whole(logits), self.scfg.temperature, key=key,
                     split_key=True).long()
        mesh = getattr(like, "device_mesh", None)
        if mesh is None:
            return tok
        from torch.distributed.tensor import DTensor, Replicate

        return DTensor.from_local(tok, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(mesh, like.placements)

    def _static_step(self, st: _StaticDecode) -> None:
        """:meth:`_step` over the static buffers, every write in place: the
        step that a CUDA graph captures."""
        cur = st.cur[:, 0]
        st.out_buf.index_copy_(1, st.t, torch.where(st.done, st.pad_id, cur)[:, None])
        st.n_emit += (~st.done).long()
        st.done |= cur == self.tok.eos_id
        logits, cache = self.api.decode_step(self.model, st.cur, st.pos, st.cache)
        _copy_into(st.cache, cache)
        st.cur.copy_(self._next(logits, st.key, cur)[:, None])
        st.pos += 1
        st.t += 1

    def _static_for(self, cache, b: int, n_new: int) -> _StaticDecode:
        """The static buffers (and, in graph mode, the captured step) of
        this capture key, made at its first use."""
        key = (self.cfg.family, b, self.scfg.max_len, n_new, self.scfg.greedy,
               flags.DECODE_CHUNKED,
               tuple((tuple(t.shape), t.dtype) for t in tree_leaves(cache)))
        st = self._static.get(key)
        if st is None:
            st = _StaticDecode(cache, b, n_new, self.tok.pad_id)
            if self.decode == "graph":
                t0 = time.perf_counter()
                st.graph = self._capture(st)
                self.capture_s = time.perf_counter() - t0
                self.captures += 1
            self._static[key] = st
        return st

    def _capture(self, st: _StaticDecode) -> torch.cuda.CUDAGraph:
        """Capture :meth:`_static_step` over ``st``'s zeroed buffers, after a
        warm-up on a side stream (its writes are overwritten by the next
        ``start``).  Raises if the step cannot be captured."""
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                st.t.zero_()
                self._static_step(st)
        torch.cuda.current_stream(self.device).wait_stream(side)
        st.t.zero_()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._static_step(st)
        return graph

    def inputs(self, texts: List[str]) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
        """The prefill batch of ``texts`` (laid out over the mesh, if any)
        and their prompt lengths."""
        dev = self.device
        prompts = [self.tok.encode(t, add_eos=False) for t in texts]
        toks, lens = self._pad_prompts(prompts)
        b = toks.shape[0]
        batch: Dict[str, torch.Tensor] = {
            "tokens": torch.from_numpy(toks).to(dev),
            "lengths": torch.from_numpy(lens).to(dev),
        }
        if self.cfg.family == "encdec":  # the audio frontend is a stub
            batch["frames"] = torch.zeros(
                (b, self.cfg.enc_frames, self.cfg.d_model), dtype=torch.float32,
                device=dev)
        if self.cfg.family == "vlm":  # the vision frontend is a stub
            batch["patch_embeds"] = torch.zeros(
                (b, self.cfg.n_img_tokens, self.cfg.d_model), dtype=torch.float32,
                device=dev)
        return self._shard_batch(batch), lens

    @torch.no_grad()
    def generate(self, texts: List[str]) -> List[GenerationResult]:
        with span("Engine.inputs"):
            batch, lens = self.inputs(texts)
        b = len(texts)
        key = None if self.scfg.greedy else prng_key(self.scfg.seed, self.device)

        self._sync()
        t0 = time.perf_counter()
        with span("Engine.prefill"), use_mesh(self.mesh):
            logits, cache = self.api.prefill(self.model, batch,
                                             max_len=self.scfg.max_len)
            cache = self._shard_cache(cache)
            self._sync()
        prefill_s = time.perf_counter() - t0
        self.kv_cache_bytes = _nbytes(cache)

        with use_mesh(self.mesh):
            pos = batch["lengths"] + (self.cfg.n_img_tokens or 0)
            cur = torch.argmax(logits, dim=-1)[:, None]
            n_new = self.scfg.max_new_tokens
            # the decode bookkeeping lies as the batch lies (a DTensor on a mesh)
            out_buf = torch.full_like(cur, self.tok.pad_id).expand(b, n_new).clone()
            n_emit = torch.zeros_like(cur[:, 0])
            done = torch.zeros_like(cur[:, 0], dtype=torch.bool)

        st = None
        if self.decode != "eager" and not monitored(self.model):
            with span("Engine.decode.start"):
                st = self._static_for(cache, b, n_new)
                st.start(cache, cur, pos, key)
            del cache
            out_buf, n_emit, done = st.out_buf, st.n_emit, st.done

        t1 = time.perf_counter()
        steps = 0
        sync_every = max(1, self.scfg.sync_every)
        with span("Engine.decode"):
            for step in range(n_new):
                if step % sync_every == 0 and step:
                    with span("Engine.decode.done_check"):
                        all_done = bool(whole(done).all())
                    if all_done:
                        break
                with span("Engine.decode.replay"):
                    if st is None:
                        with use_mesh(self.mesh):
                            cur, pos, cache = self._step(cur, pos, cache, out_buf,
                                                         n_emit, done, step, key)
                    elif st.graph is not None:
                        st.graph.replay()
                        self.replays += 1
                    else:
                        self._static_step(st)
                steps += 1
            self._sync()
        decode_s = time.perf_counter() - t1

        with span("Engine.readback"):
            out_np = whole(out_buf).cpu().numpy()  # the one transfer of tokens
            emitted = whole(n_emit).cpu().numpy()
        outs = [out_np[i, : emitted[i]].tolist() for i in range(b)]
        return [
            GenerationResult(
                text=self.tok.decode(outs[i]),
                token_ids=outs[i],
                prompt_len=int(lens[i]),
                steps=steps,
                prefill_s=prefill_s,
                decode_s=decode_s,
            )
            for i in range(b)
        ]
