"""Shared model substrate of the port: norms, RoPE, GQA attention, the
SwiGLU MLP, the embeddings and the chunked cross entropy of training
(the reference's ``models/common.py``).

Conventions
-----------
* Layers are ``nn.Module``s holding only their parameters, under the
  reference's names (``wq``, ``wk``, ``wv``, ``wo``, ``bq`` ..., ``wg``,
  ``wu``, ``wd``, ``table``, ``unembed``); the reference's functions keep
  their names and take the module where the reference took a params dict.
* The reference keeps float32 masters and casts each matrix to the compute
  dtype at every use.  A serving module of the port stores each matrix in
  the compute dtype, cast once at load, which gives the same values; a
  training module keeps float32 masters (``train.loop.make_train_state``).
  Every use goes through :func:`cast`, a no-op for the first and the
  reference's differentiable cast for the second.  Norm weights stay
  float32, as ``rmsnorm`` reads them.
* Training recomputes activations in the backward pass under the remat
  policy (``flags.REMAT_POLICY``, the counterpart of the reference's
  ``jax.checkpoint`` of its layer scan): under "names", the default, each
  sublayer on its own (:func:`remat_sublayer`), under "nothing" each whole
  layer (:func:`remat_layer`); :func:`chunked_xent` recomputes each logits
  chunk under either.
* Full-sequence attention goes through ``flash_attention`` (the CUDA kernel
  for a CUDA tensor, the plain version on the CPU).  One-token decode is
  the reference's default unchunked path: a grouped product with float32
  accumulation and a float32 result, masked softmax, product with V; with
  ``flags.DECODE_CHUNKED`` set, :func:`decode_attention_chunked`, an
  online softmax over KV chunks.  It updates the cache in place
  (``index_put_`` at each row's slot, on each rank's local block under a
  mesh: :func:`write_slots`), where the reference rebuilds it
  functionally and donates the old one.
* The paged cache (continuous batching) is one pool ``(Hkv, n_blocks *
  block_size, Dh)`` per layer shared by every batch slot through block
  tables; ``attention_decode_paged`` writes the new token's row into the
  pool in place, gathers each slot's blocks (``paged_view``) and runs the
  decode math above on the view, so it equals the contiguous cache's
  bit for bit whenever the view is as long.
* ``init_*`` draw the reference's distributions from a ``torch.Generator``
  on the target device; the numbers differ from ``jax.random``'s, so
  parity runs carry the reference's weights across (``models/weights.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import flags
from ..configs.base import ModelConfig
from ..dist.logical import (
    carry,
    constrain,
    current_mesh,
    on_local_blocks,
    replicate,
    resolved_placements,
)
from ..kernels.flash_attention.ops import flash_attention

__all__ = [
    "Attention",
    "Embed",
    "RMSNorm",
    "SwiGLU",
    "apply_rope",
    "attend",
    "attention_apply",
    "attention_decode",
    "attention_decode_paged",
    "attention_init",
    "cast",
    "chunked_xent",
    "compute_dtype",
    "decode_attention_chunked",
    "dense_init",
    "draw_qkv_biases",
    "embed_apply",
    "embed_init",
    "last_token_logits",
    "mlp_apply",
    "mlp_init",
    "paged_view",
    "pad_dim",
    "paged_write_rows",
    "param_count",
    "remat",
    "remat_layer",
    "remat_sublayer",
    "rmsnorm",
    "rmsnorm_init",
    "rope_freqs",
    "split_heads",
    "tp_input",
    "unembed_logits",
    "unembed_weight",
    "write_slots",
]

NEG_INF = -1e30


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _param(t: torch.Tensor) -> nn.Parameter:
    # serving modules: no gradients are taken through the weights (training
    # turns them on, over float32 masters: train.loop.make_train_state)
    return nn.Parameter(t, requires_grad=False)


def cast(t: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``t`` in the compute dtype, the reference's ``.astype(cdt)`` at a
    use: nothing to do for a serving module's matrices (stored in it), a
    differentiable cast of a training module's float32 masters."""
    cdt = compute_dtype(cfg)
    return t if t.dtype == cdt else t.to(cdt)


def remat(fn, *args):
    """``fn(*args)``; while gradients are recorded, its activations are not
    kept but recomputed in the backward pass (``torch.utils.checkpoint``,
    non-reentrant, which stops recomputing once the backward has every
    tensor it needs: the matmul that ends ``fn`` does not run again).  The
    recomputation runs under the forward's mesh and rules
    (``dist.logical.carry``), in whichever thread autograd runs it."""
    if torch.is_grad_enabled():
        enter = carry()

        def run(*a):
            with enter():
                return fn(*a)

        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)
    return fn(*args)


def remat_layer(fn, *args):
    """One layer of a stack, ``fn(*args)``, under the remat policy
    (``flags.REMAT_POLICY``, read at each call).  "nothing": the whole
    layer under :func:`remat`, so only its input is kept.  "names" (the
    default): the layer runs as it is and each of its sublayers
    (:func:`remat_sublayer`) recomputes on its own, so the residual stream
    between sublayers, which holds the attention, FFN and mixer outputs, is
    kept and the backward pass does not re-run the matmul that ends each
    sublayer, as the reference's ``save_only_these_names`` policy keeps
    ``attn_out``, ``ffn_out`` and ``mixer_out``.  Both give the same
    gradients bit for bit: the autograd graph is the same, only what it
    keeps differs."""
    if flags.remat_policy():
        return fn(*args)
    return remat(fn, *args)


def remat_sublayer(name: str, fn, *args):
    """A sublayer of a layer run by :func:`remat_layer`: ``fn(*args)``
    from the residual stream to the sublayer's output (its norm included),
    under :func:`remat` when the policy keeps ``name`` (one of
    ``flags.remat_policy()``), plain otherwise (the enclosing layer is
    recomputed whole)."""
    if name in flags.remat_policy():
        return remat(fn, *args)
    return fn(*args)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(shape, generator: torch.Generator,
               scale: Optional[float] = None) -> torch.Tensor:
    """He-style float32 init, ``scale * N(0, 1)`` with ``scale`` defaulting
    to ``1 / sqrt(fan_in)``, on the generator's device."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    return scale * torch.randn(shape, generator=generator,
                               device=generator.device, dtype=torch.float32)


def rmsnorm_init(d: int, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * w.float()
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, weight: torch.Tensor, eps: float = 1e-6):
        super().__init__()
        self.weight = _param(weight.float())
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.weight, self.eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (..., S, H, Dh), positions broadcastable to (..., S)."""
    freqs = replicate(rope_freqs(x.shape[-1], theta, x.device))  # (Dh/2,)
    angles = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA projections: ``wq (D, H*Dh)``, ``wk, wv (D, Hkv*Dh)``,
    ``wo (H*Dh, D)``, and the qkv biases where the config has them."""

    def __init__(self, wq, wk, wv, wo, bq=None, bk=None, bv=None):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = map(_param, (wq, wk, wv, wo))
        self.bq, self.bk, self.bv = (
            None if b is None else _param(b) for b in (bq, bk, bv)
        )


def attention_init(cfg: ModelConfig, generator: torch.Generator) -> Attention:
    cdt = compute_dtype(cfg)
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    ws = [dense_init(s, generator).to(cdt)
          for s in ((d, h * dh), (d, hkv * dh), (d, hkv * dh), (h * dh, d))]
    biases = [None] * 3
    if cfg.qkv_bias:
        biases = [torch.zeros((n,), dtype=cdt, device=generator.device)
                  for n in (h * dh, hkv * dh, hkv * dh)]
    return Attention(*ws, *biases)


def draw_qkv_biases(model: nn.Module, generator: torch.Generator) -> int:
    """Fill every attention's ``bq``, ``bk`` and ``bv`` (configs with
    ``qkv_bias``) in place with N(0, 1) draws from ``generator``, module by
    module, each vector drawn in float32 on the generator's device and cast
    to its parameter's dtype and device.  The inits keep the reference's
    zeros; random weights drawn for a check or a served run call this so
    that the bias add is exercised, as a trained checkpoint's nonzero
    biases exercise it.  A unit bias is of the size of its projection's
    output (a normalised input through ``dense_init``'s
    ``1 / sqrt(fan_in)``).  Returns how many attention modules it filled
    (none on a config without biases)."""
    n = 0
    with torch.no_grad():
        for m in model.modules():
            if not isinstance(m, Attention) or m.bq is None:
                continue
            for b in (m.bq, m.bk, m.bv):
                b.copy_(torch.randn(b.shape, generator=generator,
                                    device=generator.device, dtype=torch.float32))
            n += 1
    return n


def pad_dim(t: torch.Tensor, dim: int, before: int, after: int) -> torch.Tensor:
    """``t`` with ``before`` zero rows in front of dim ``dim`` and ``after``
    behind it (``F.pad``).  Under a mesh on each rank's local block, the
    padded dim made whole first: DTensor pads only a tensor replicated
    everywhere, and some torch versions fail to plan that layout change
    from two sharded dims."""
    pads = [0, 0] * (t.dim() - 1 - dim) + [before, after]
    mesh = current_mesh()
    if mesh is None:
        return F.pad(t, pads)
    from torch.distributed.tensor import Replicate

    pl = tuple(Replicate() if p.is_shard(dim) else p for p in t.placements)
    return on_local_blocks(functools.partial(F.pad, pad=pads), (pl,), pl)(t)


def tp_input(x: torch.Tensor) -> torch.Tensor:
    """``x (B, S, D)`` laid out for a projection: under a mesh, batch over
    the dp axes and the rest whole on every rank (Megatron's gather of the
    sequence-parallel residual before a column-parallel matmul, which
    GSPMD inserts by itself).  DTensor's matmul flattens ``(B, S)``, which
    not every torch version can do across two sharded dims."""
    mesh = current_mesh()
    if mesh is None:
        return x
    pl = resolved_placements(("batch",), x.shape, mesh)
    return x if tuple(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def split_heads(t: torch.Tensor, h: int, dh: int) -> torch.Tensor:
    """``t (..., H * Dh)`` viewed as ``(..., H, Dh)``.  Under a mesh the flat
    dim may be split over "model" only at head boundaries, so it is first
    laid out as heads over "model" allow (whole where ``H`` does not
    divide), batch over the dp axes."""
    mesh = current_mesh()
    if mesh is not None:
        logical = ("batch",) + (None,) * (t.dim() - 2) + ("heads",)
        pl = resolved_placements(logical, tuple(t.shape[:-1]) + (h,), mesh)
        if tuple(t.placements) != pl:
            t = t.redistribute(t.device_mesh, pl)
    return t.view(*t.shape[:-1], h, dh)


def _qkv(attn: Attention, cfg: ModelConfig, x: torch.Tensor):
    """x (B, S, D) -> q (B,S,H,Dh), k/v (B,S,Hkv,Dh) in compute dtype."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = tp_input(x)
    q = x @ cast(attn.wq, cfg)
    k = x @ cast(attn.wk, cfg)
    v = x @ cast(attn.wv, cfg)
    if cfg.qkv_bias:
        q = q + cast(attn.bq, cfg)
        k = k + cast(attn.bk, cfg)
        v = v + cast(attn.bv, cfg)
    return split_heads(q, h, dh), split_heads(k, hkv, dh), split_heads(v, hkv, dh)


def attention_apply(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                   # (B, S, D)
    positions: torch.Tensor,           # (S,) or (B, S)
    causal: bool = True,
    window: Optional[int] = None,
    use_rope: bool = True,
    kv_from: Optional[torch.Tensor] = None,  # cross-attention source (B, F, D)
) -> torch.Tensor:
    """Full-sequence attention (train / prefill / cross)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if kv_from is None:
        q, k, v = _qkv(attn, cfg, x)
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        # cross attention: q from x, k/v from the encoder output (no RoPE)
        f = kv_from.shape[1]
        kv_from = tp_input(kv_from)
        q = split_heads(tp_input(x) @ cast(attn.wq, cfg), h, dh)
        k = split_heads(kv_from @ cast(attn.wk, cfg), hkv, dh)
        v = split_heads(kv_from @ cast(attn.wv, cfg), hkv, dh)
        causal, window = False, None
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "heads", None)
    v = constrain(v, "batch", "seq", "heads", None)
    out = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=causal, window=window)                # (B, H, S, Dh)
    out = out.transpose(1, 2).reshape(b, s, h * dh)
    return constrain(out @ cast(attn.wo, cfg), *flags.residual_axes())


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """``flash_attention`` of ``q (B, H, Sq, Dh)`` against ``k, v (B, Hkv,
    Skv, Dh)``.  Under a mesh the DTensors are laid out batch over the dp
    axes and heads over "model" (``local_map``), and each rank launches the
    kernel on its local block, forward and backward; the kernel never sees
    a DTensor.  Where the query heads and the kv heads do not both divide
    "model" (GQA with fewer kv heads than "model", the KV-cache fallback of
    ``launch.sharding``), the kernel pairs query head ``h`` with kv head
    ``h // G`` and needs whole heads and whole sequences, so the inputs are
    redistributed to heads whole on every rank first: GSPMD's partial
    softmax over a sequence-sharded K/V has no counterpart inside a
    hand-written kernel."""
    mesh = current_mesh()
    if mesh is None:
        return flash_attention(q, k, v, causal=causal, window=window)
    pq = resolved_placements(("batch", "heads"), q.shape, mesh)
    pk = resolved_placements(("batch", "heads"), k.shape, mesh)
    if pq != pk:
        pq = pk = resolved_placements(("batch",), q.shape, mesh)
    fn = functools.partial(flash_attention, causal=causal, window=window)
    return on_local_blocks(fn, (pq, pk, pk), pq)(q, k, v)


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two batched operands in the cache dtype, summed and
    returned in float32 (the reference's ``preferred_element_type``)."""
    if a.dtype == torch.float32:
        return torch.matmul(a, b)
    if a.is_cuda:
        lead = a.shape[:-2]
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
        return out.view(*lead, *out.shape[-2:])
    # products of bfloat16 values are exact in float32
    return torch.matmul(a.float(), b.float())


def _decode_ctx(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                valid: Optional[torch.Tensor] = None,
                chunked: bool = False) -> torch.Tensor:
    """:func:`_decode_ctx_local` (``chunked``: :func:`_decode_ctx_chunked`);
    under a mesh on each rank's local (batch, kv heads) block
    (``local_map``): its grouped products reshape the batch and head dims
    together, which DTensor cannot do across shards.  A cache whose
    sequence is sharded (the KV fallback) is gathered whole first, where
    GSPMD would combine partial softmaxes."""
    local = _decode_ctx_chunked if chunked else _decode_ctx_local
    mesh = current_mesh()
    if mesh is None:
        return local(q, k_cache, v_cache, valid)
    pq = resolved_placements(("batch", "heads"), q.shape, mesh)
    pk = resolved_placements(("batch", "kv_heads"), k_cache.shape, mesh)
    if pq != pk:   # the query heads of a kv head must be local with it
        pq = pk = resolved_placements(("batch",), q.shape, mesh)
    pv = None if valid is None else resolved_placements(("batch",), valid.shape, mesh)
    return on_local_blocks(local, (pq, pk, pk, pv), pq)(q, k_cache, v_cache, valid)


def _decode_ctx_local(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, Dh) against a (B, Hkv, S, Dh) cache with ``valid`` (B, S),
    every row when None → context (B, H * Dh) float32: the grouped
    products."""
    b, h, dh = q.shape
    hkv = k_cache.shape[1]
    qg = q.reshape(b, hkv, h // hkv, dh).to(k_cache.dtype)
    s = _matmul_f32(qg, k_cache.transpose(2, 3)) / math.sqrt(dh)  # (B,Hkv,G,S)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _matmul_f32(p.to(v_cache.dtype), v_cache).reshape(b, h * dh)  # (B,Hkv,G,Dh)


def _decode_ctx_chunked(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """:func:`decode_attention_chunked` as :func:`_decode_ctx_local` returns
    its context: (B, H * Dh) float32."""
    b, h, dh = q.shape
    return decode_attention_chunked(q, k_cache, v_cache, valid).reshape(b, h * dh)


def decode_attention_chunked(
    q: torch.Tensor,         # (B, H, Dh)
    k_cache: torch.Tensor,   # (B, Hkv, S, Dh)
    v_cache: torch.Tensor,   # (B, Hkv, S, Dh)
    valid: torch.Tensor,     # (B, S) bool
    chunk: int = 2048,
) -> torch.Tensor:
    """One-token GQA attention over a cache, an online softmax over KV
    chunks of ``chunk`` rows (the reference's ``decode_attention_chunked``)
    → (B, H, Dh) float32.  An ``(m, l, acc)`` carry in float32 caps the
    live scores at (B, H, chunk) where the one-pass path makes (B, H, S);
    the last chunk is padded with masked rows.  Each chunk's products run
    in the cache dtype with float32 sums, as the one-pass path's do."""
    b, h, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    c = min(chunk, s)
    qg = (q / math.sqrt(dh)).reshape(b, hkv, g, dh).to(k_cache.dtype)
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, dh), dtype=torch.float32, device=q.device)
    for lo in range(0, s, c):
        kb, vb = k_cache[:, :, lo:lo + c], v_cache[:, :, lo:lo + c]
        vm = valid[:, lo:lo + c]
        pad = c - vm.shape[1]
        if pad:
            kb, vb = F.pad(kb, (0, 0, 0, pad)), F.pad(vb, (0, 0, 0, pad))
            vm = F.pad(vm, (0, pad))
        vm = vm[:, None, None, :]
        sc = torch.where(vm, _matmul_f32(qg, kb.transpose(2, 3)), NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None]) * vm
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        acc = acc * alpha[..., None] + _matmul_f32(p.to(vb.dtype), vb)
        m = m_new
    l_safe = torch.where(l > 0, l, 1.0)
    return (acc / l_safe[..., None]).reshape(b, h, dh)


def write_slots(k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor,
                v_new: torch.Tensor, slot: torch.Tensor) -> None:
    """``cache[b, :, slot[b]] = new[b]`` for every row ``b`` of the ``(B, H,
    S, D)`` caches, ``new (B, H, D)``, in place.  Under a mesh each rank
    writes its local blocks of the caches as they are laid out
    (``local_map``): its rows, its heads, and where the sequence is sharded
    (the KV fallback) only the slots that fall in its part of it."""
    mesh = current_mesh()
    if mesh is None:
        _write_slots_local(k_cache, v_cache, k_new, v_new, slot)
        return
    from torch.distributed.tensor import Replicate, Shard

    pb = tuple(k_cache.placements)
    if tuple(v_cache.placements) != pb:   # a relayout would write a copy
        raise ValueError(f"K cache laid out {pb}, V cache {v_cache.placements}")
    pn = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in pb)
    ps = tuple(p if p == Shard(0) else Replicate() for p in pb)
    seq = [j for j, p in enumerate(pb) if p == Shard(2)]   # major first
    write = _write_slots_local
    if seq:
        part, coord = 0, mesh.get_coordinate()
        for j in seq:
            part = part * mesh.size(j) + coord[j]

        def write(kb, vb, kn, vn, sl):
            rows = kb.shape[2]
            local = sl - part * rows
            inside = ((local >= 0) & (local < rows))[:, None, None]
            local = local.clamp(0, rows - 1)
            at = torch.arange(kb.shape[0], device=kb.device)
            kn = torch.where(inside, kn.to(kb.dtype), kb[at, :, local])
            vn = torch.where(inside, vn.to(vb.dtype), vb[at, :, local])
            return _write_slots_local(kb, vb, kn, vn, local)

    on_local_blocks(write, (pb, pb, pn, pn, ps), [pb, pb])(
        k_cache, v_cache, k_new, v_new, slot)


def _write_slots_local(k_cache, v_cache, k_new, v_new, slot):
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, :, slot] = k_new.to(k_cache.dtype)
    v_cache[rows, :, slot] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def attention_decode(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, 1, D)
    pos: torch.Tensor,                  # (B,) absolute position of the new token
    cache: Dict[str, torch.Tensor],     # {"k","v"}: (B, Hkv, S_slots, Dh)
    window: Optional[int] = None,
    use_rope: bool = True,
    update_cache: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  Contiguous cache when ``window is None`` (slot =
    absolute position); ring buffer otherwise (slot = pos % window).  The
    new key and value are written into ``cache`` in place; a slot past the
    end is clamped to the last one, as the reference's
    ``dynamic_update_slice`` clamps it."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _qkv(attn, cfg, x)                 # (B,1,H,Dh) / (B,1,Hkv,Dh)
    if use_rope:
        p1 = pos[:, None]
        q = apply_rope(q, p1, cfg.rope_theta)
        k = apply_rope(k, p1, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    slots = k_cache.shape[2]
    if update_cache:
        slot = (pos % window if window is not None else pos).clamp(max=slots - 1)
        write_slots(k_cache, v_cache, k[:, 0], v[:, 0], slot)

    idx = replicate(torch.arange(slots, device=x.device)[None, :])  # (1, S_slots)
    if window is None:
        valid = idx <= pos[:, None]
    else:
        # ring buffer: slot s holds token t = pos - ((pos - s) mod W)
        valid = pos[:, None] - (pos[:, None] - idx) % window >= 0
    ctx = _decode_ctx(q[:, 0], k_cache, v_cache, valid, chunked=flags.DECODE_CHUNKED)
    ctx = ctx.to(compute_dtype(cfg))
    return (ctx @ cast(attn.wo, cfg))[:, None, :], cache


# ---------------------------------------------------------------------------
# paged (block) KV cache
# ---------------------------------------------------------------------------
#
# One pool (Hkv, P, Dh) per layer with P = n_blocks * block_size; block i
# owns rows [i*bs, (i+1)*bs).  A slot's block table row maps logical
# position t to pool row ``table[t // bs] * bs + t % bs``.  Block 0 is the
# trash block: unallocated table entries point at it, writes from inactive
# slots land there, and reads from it are always masked (``idx <= pos``).


def paged_view(pool: torch.Tensor, tables: torch.Tensor, block_size: int) -> torch.Tensor:
    """Gather per-slot contiguous KV views out of the block pool: pool
    (Hkv, P, Dh), tables (B, M) → (B, Hkv, M * bs, Dh), whatever number of
    blocks a slot really owns."""
    b, m = tables.shape
    flat = (tables.long()[:, :, None] * block_size
            + torch.arange(block_size, device=tables.device)[None, None, :]
            ).reshape(b, m * block_size)
    return pool[:, flat].transpose(0, 1)


def paged_write_rows(
    pool: torch.Tensor,        # (Hkv, P, Dh)
    rows: torch.Tensor,        # (Hkv, S, Dh) values of logical positions start..start+S-1
    table_row: torch.Tensor,   # (M,) block table of the target slot
    block_size: int,
    start: int = 0,
) -> torch.Tensor:
    """Scatter S contiguous logical positions of one slot into the pool, in
    place, and return it.  ``start`` offsets the logical positions (suffix
    prefill writes after adopted prefix blocks and leaves them untouched).
    Positions past the slot's allocated blocks resolve to the trash block;
    positions past the table raise."""
    t = start + torch.arange(rows.shape[1], device=pool.device)
    flat = table_row.long()[t // block_size] * block_size + t % block_size
    pool[:, flat] = rows.to(pool.dtype)
    return pool


def attention_decode_paged(
    attn: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,                    # (B, 1, D)
    pos: torch.Tensor,                  # (B,) absolute position of the new token
    cache: Dict[str, torch.Tensor],     # {"k","v"}: (Hkv, P, Dh) block pools
    tables: torch.Tensor,               # (B, M) block tables
    block_size: int,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode against the paged pool, write-then-gather: the new
    token's K/V goes to its slot's block at ``pos`` (in place), the slot's
    blocks are gathered into a (B, Hkv, M * bs, Dh) view, and the math is
    :func:`attention_decode`'s, with the same masking constant."""
    b = x.shape[0]
    h, dh = cfg.n_heads, cfg.resolved_head_dim
    q, k, v = _qkv(attn, cfg, x)                 # (B,1,H,Dh) / (B,1,Hkv,Dh)
    if use_rope:
        p1 = pos[:, None]
        q = apply_rope(q, p1, cfg.rope_theta)
        k = apply_rope(k, p1, cfg.rope_theta)
    rows = torch.arange(b, device=x.device)
    flat_w = tables.long()[rows, pos // block_size] * block_size + pos % block_size
    k_pool, v_pool = cache["k"], cache["v"]
    k_pool[:, flat_w] = k[:, 0].transpose(0, 1).to(k_pool.dtype)
    v_pool[:, flat_w] = v[:, 0].transpose(0, 1).to(v_pool.dtype)
    # contiguous, as the dense cache is, so the products take the same path
    k_cache = paged_view(k_pool, tables, block_size).contiguous()
    v_cache = paged_view(v_pool, tables, block_size).contiguous()
    valid = torch.arange(k_cache.shape[2], device=x.device)[None, :] <= pos[:, None]
    ctx = _decode_ctx(q[:, 0], k_cache, v_cache, valid, chunked=flags.DECODE_CHUNKED)
    ctx = ctx.to(compute_dtype(cfg))
    return (ctx @ cast(attn.wo, cfg))[:, None, :], cache


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

class SwiGLU(nn.Module):
    """``wg, wu (D, F)``, ``wd (F, D)``."""

    def __init__(self, wg, wu, wd):
        super().__init__()
        self.wg, self.wu, self.wd = map(_param, (wg, wu, wd))


def mlp_init(cfg: ModelConfig, generator: torch.Generator,
             d_ff: Optional[int] = None) -> SwiGLU:
    cdt = compute_dtype(cfg)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return SwiGLU(*(dense_init(s, generator).to(cdt)
                    for s in ((d, f), (d, f), (f, d))))


def mlp_apply(mlp: SwiGLU, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = tp_input(x)
    h = constrain(F.silu(x @ cast(mlp.wg, cfg)) * (x @ cast(mlp.wu, cfg)),
                  "batch", "seq", "d_ff")
    return constrain(h @ cast(mlp.wd, cfg), *flags.residual_axes())


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """``table (V, D)`` and, unless the embeddings are tied, ``unembed
    (D, V)``."""

    def __init__(self, table, unembed=None):
        super().__init__()
        self.table = _param(table)
        self.unembed = None if unembed is None else _param(unembed)


def embed_init(cfg: ModelConfig, generator: torch.Generator) -> Embed:
    cdt = compute_dtype(cfg)
    v, d = cfg.vocab_size, cfg.d_model
    table = dense_init((v, d), generator, scale=0.02).to(cdt)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = dense_init((d, v), generator, scale=0.02).to(cdt)
    return Embed(table, unembed)


def embed_apply(embed: Embed, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # gather, then cast the rows (the reference casts the table, then
    # gathers: the same values, without a cast copy of the whole table).
    # F.embedding, not indexing: its backward sums a row's gradients in one
    # order on the CPU and on the card, where the CPU's index backward
    # (a parallel accumulate) rounds differently run to run.  Under a mesh
    # the table is first laid out vocab-whole, d_model over the FSDP axes,
    # as the reference relayouts it for the lookup
    table = constrain(embed.table, None, "embed")
    return constrain(cast(F.embedding(tokens, table), cfg), "batch", "seq", None)


def unembed_weight(embed: Embed, cfg: ModelConfig) -> torch.Tensor:
    """The ``(D, V)`` unembedding in the compute dtype."""
    return cast(embed.table.T if cfg.tie_embeddings else embed.unembed, cfg)


def unembed_logits(embed: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return constrain(tp_input(x) @ unembed_weight(embed, cfg), "batch", "seq", "vocab")


def last_token_logits(
    embed: Embed,
    cfg: ModelConfig,
    hidden: torch.Tensor,                   # (B, S, D) final hidden states
    lengths: Optional[torch.Tensor] = None,  # (B,) true prompt lengths
    offset: int = 0,                        # prepended non-text positions (VLM)
) -> torch.Tensor:
    """Logits at each sequence's true last prompt position: a right-padded
    ragged batch reads row ``offset + lengths - 1``, not a pad row.
    ``lengths=None`` reads the last row."""
    if lengths is None:
        last = hidden[:, -1]
    else:
        rows = replicate(torch.arange(hidden.shape[0], device=hidden.device))
        last = hidden[rows, lengths.long() + offset - 1]
    return unembed_logits(embed, cfg, last[:, None])[:, 0]


def _chunk_nll(hx: torch.Tensor, tx: torch.Tensor, mx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """Masked summed NLL of one chunk: a ``(B, c, V)`` float32 logits slab,
    its log-sum-exp and the target logits."""
    # under a mesh the chunk's logits are gathered whole over the vocab
    # first: DTensor's vocab-parallel gather (its masked partial) fails on
    # this index shape, where GSPMD's take_along_axis partitions
    logits = constrain((tp_input(hx) @ w).float(), "batch", "seq", None)
    lse = torch.logsumexp(logits, dim=-1)                         # (B, c)
    tgt = torch.gather(logits, -1, tx[..., None].long())[..., 0]
    return torch.sum((lse - tgt) * mx)


def chunked_xent(
    embed: Embed,
    cfg: ModelConfig,
    hidden: torch.Tensor,                  # (B, S, D) final hidden states
    targets: torch.Tensor,                 # (B, S) next-token ids
    mask: Optional[torch.Tensor] = None,   # (B, S) 1 = contributes to the loss
    chunk: int = 512,
) -> torch.Tensor:
    """Mean cross entropy over the masked positions without a ``(B, S, V)``
    logits tensor: the sequence goes in chunks of ``chunk`` positions (the
    last one ragged, where the reference pads it with masked rows), each a
    ``(B, chunk, V)`` float32 slab.  While gradients are recorded each
    chunk runs under :func:`remat`, which keeps only its inputs and
    recomputes its logits in the backward pass, so one slab (and its
    gradient) is the peak at any time.  The mean divides by ``max(sum(mask),
    1)``."""
    b, s, _ = hidden.shape
    if mask is None:
        mask = replicate(torch.ones((b, s), dtype=torch.float32, device=hidden.device))
    mask = mask.float()
    c = min(chunk, s)
    w = unembed_weight(embed, cfg)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for lo in range(0, s, c):
        total = total + remat(_chunk_nll, hidden[:, lo:lo + c],
                              targets[:, lo:lo + c], mask[:, lo:lo + c], w)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def param_count(model: nn.Module) -> int:
    """Number of parameter elements of ``model``."""
    return int(sum(p.numel() for p in model.parameters()))
