"""Static-batch serving engine of the port: prefill + decode over the
uniform model API (the reference's ``serve/engine.py``).

A batch of prompts is right-padded to a common length, prefilled once with
each sequence's true length (so its first token comes from its own last
prompt position, not a pad row), then decoded token by token with
per-sequence positions until EOS or the token budget.  The decode loop
keeps everything on the device: each step emits the current tokens into a
device-side buffer, updates the EOS flags and runs the decode step; the
host reads only the all-done flag every ``sync_every`` steps, and copies
the token buffer back once at the end.  The two phases run inside
``torch.profiler.record_function`` spans named ``Engine.prefill`` and
``Engine.decode`` (free when no profiler is active), so a profile of
``generate`` splits its device time between them.

Over a mesh (``Engine(..., mesh=, param_specs=)``) the engine serves a
copy of the model whose parameters are DTensors laid out by their logical
specs (``models.specs.param_specs``; replicated without specs), the
request batch goes over the mesh's data-parallel axes, the KV and
recurrent caches are laid out by their cache specs as soon as the prefill
makes them, and the prefill and every decode step run under
``dist.logical.use_mesh``.  Every rank runs ``generate`` on the same
texts and gets the same tokens.  The caller's model is left as it was.

Greedy decoding takes the first maximal logit, as ``jnp.argmax`` does, so
on float32 weights it gives the reference's tokens.  Sampling draws from
the engine's ``torch.Generator``, seeded with ``ServeConfig.seed`` at every
``generate``; its draws are not ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..data.tokenizer import ByteTokenizer
from ..device import DeviceLike, resolve_device
from ..dist.logical import use_mesh, whole
from ..launch.sharding import (
    batch_shardings,
    distribute,
    distribute_params,
    module_copy,
    redistribute_tree,
    shardings_from_specs,
)
from ..models.registry import build_model
from ..models.specs import cache_specs

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

    @property
    def tokens_per_s(self) -> float:
        return self.steps / self.decode_s if self.decode_s > 0 else float("inf")


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
    model's parameters must already be."""

    def __init__(self, cfg: ModelConfig, model: torch.nn.Module,
                 scfg: ServeConfig = ServeConfig(), device: DeviceLike = "cuda",
                 mesh=None, param_specs: Optional[Mapping[str, Any]] = None):
        self.cfg = cfg
        self.api = build_model(cfg)
        self.scfg = scfg
        self.device = resolve_device(device)
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
        self._gen = torch.Generator(device=self.device)
        # bytes of the KV cache that the last ``generate``'s prefill allocated
        # (the encoder-decoder family's cross cache included)
        self.kv_cache_bytes = 0

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

    def _step(self, cur, pos, cache, out_buf, n_emit, done, t):
        """Emit ``cur`` at column ``t``, update the EOS flags, decode one
        token: all on the device, no host transfer."""
        out_buf[:, t] = torch.where(done, self.tok.pad_id, cur[:, 0])
        n_emit += (~done).long()
        done |= cur[:, 0] == self.tok.eos_id
        logits, cache = self.api.decode_step(self.model, cur, pos, cache)
        if self.scfg.greedy:
            nxt = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return nxt[:, None], pos + 1, cache

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
        batch, lens = self.inputs(texts)
        b = len(texts)
        self._gen.manual_seed(self.scfg.seed)

        self._sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function("Engine.prefill"), use_mesh(self.mesh):
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

        t1 = time.perf_counter()
        steps = 0
        sync_every = max(1, self.scfg.sync_every)
        with torch.profiler.record_function("Engine.decode"):
            for step in range(n_new):
                if step % sync_every == 0 and step and bool(whole(done).all()):
                    break
                with use_mesh(self.mesh):
                    cur, pos, cache = self._step(cur, pos, cache, out_buf, n_emit,
                                                 done, step)
                steps += 1
            self._sync()
        decode_s = time.perf_counter() - t1

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
