"""Plain float32 reference of a Mamba2 stack (arXiv:2405.21060, the layout
state-spaces/mamba2 publishes with one group): per layer RMSNorm, the
input projection to ``[z, x, B, C, dt]``, a depthwise causal convolution
of ``[x, B, C]`` and SiLU, the selective state space of each head (state
``(P, N)``, decay ``exp(dt * A)``, input ``dt * x B^T``, output ``C h + D
x``), the gate ``y * silu(z)`` under an RMSNorm, the output projection and
the residual.  The state space runs as the chunked recurrence: inside a
chunk the causal (query, key) products, across chunks the state carried
one chunk at a time.

Computed layer by layer, each layer's weights drawn again from the seed
(``common.draw_group``); one sequence at a time.  Imports nothing of the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference.common import Spec, draw_group, fp8_round, rmsnorm

__all__ = ["PORT_FIELDS", "embed_spec", "layer_spec", "logits", "loss", "n_groups",
           "port_values", "train", "vocab"]

PORT_FIELDS = {
    "d_model": "d_model", "n_layer": "n_layers", "vocab_size": "vocab_size",
    "d_state": "ssm_state", "headdim": "ssm_head_dim", "expand": "ssm_expand",
    "d_conv": "ssm_conv", "chunk_size": "ssm_chunk", "norm_eps": "norm_eps",
    "tie_embeddings": "tie_embeddings", "torch_dtype": "dtype",
}

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# A static batch right-pads its prompts to the longest, and the served
# engine builds each row's state over the padded length (the pads run
# through the layers), then decodes from that state: the reference is fed
# the same pad tokens between a prompt and its decoded tokens.  The first
# token still comes from the prompt's own last position.
PAD_STATE = True


def vocab(c: Dict) -> int:
    """Rows of the embedding table: ``vocab_size`` padded up to its
    ``pad_vocab_size_multiple``, as the published model holds it."""
    m = c.get("pad_vocab_size_multiple", 1)
    return -(-c["vocab_size"] // m) * m


def port_values(c: Dict) -> Dict:
    """Fields of the port's config that the file states only through a
    rule: the padded vocabulary."""
    return {"vocab_size": vocab(c)}


def n_groups(c: Dict) -> int:
    return c["n_layer"]


def _dims(c: Dict):
    d_inner = c["expand"] * c["d_model"]
    h = d_inner // c["headdim"]
    n = c["d_state"] * c["ngroups"]
    return d_inner, h, c["headdim"], n, d_inner + 2 * n


def embed_spec(c: Dict) -> Spec:
    dt = _DT[c["torch_dtype"]]
    v, d = vocab(c), c["d_model"]
    spec = [("embed.table", (v, d), ("normal", 0.02), dt)]
    if not c["tie_embeddings"]:
        spec.append(("embed.unembed", (d, v), ("normal", 0.02), dt))
    spec.append(("final_norm.weight", (d,), ("around", 1.0, 0.1), torch.float32))
    return spec


def layer_spec(c: Dict, i: int) -> Spec:
    """One layer's tensors, as the published implementation initialises
    them (normal draws of the same spread where it draws uniformly): the
    projections at std 1/sqrt(3 fan_in), the output one over sqrt(n_layer)
    more (its prenorm-residual rescaling); the convolution's weights and
    bias uniform in [-1/2, 1/2] (fan-in 4); A = -exp(a_log) with A uniform
    in [1, 16]; softplus(dt_bias) log-uniform in [1e-3, 1e-1].  The norms'
    weights and D are drawn around 1, where the published init sets them
    to 1, so that a norm or skip the program dropped would show."""
    dt = _DT[c["torch_dtype"]]
    d = c["d_model"]
    d_inner, h, p, n, conv_dim = _dims(c)
    d_proj = 2 * d_inner + 2 * n + h
    f32 = torch.float32
    q = f"layers.{i}."
    m = q + "mamba."
    return [
        (q + "ln.weight", (d,), ("around", 1.0, 0.1), f32),
        (m + "in_proj", (d, d_proj), ("normal", (3 * d) ** -0.5), dt),
        (m + "conv_w", (conv_dim, c["d_conv"]), ("uniform", -0.5, 0.5), f32),
        (m + "conv_b", (conv_dim,), ("uniform", -0.5, 0.5), f32),
        (m + "a_log", (h,), ("uniform", 0.0, math.log(16.0)), f32),
        (m + "d_skip", (h,), ("around", 1.0, 0.1), f32),
        (m + "dt_bias", (h,), ("inv_softplus_log_uniform", 1e-3, 1e-1), f32),
        (m + "norm_w", (d_inner,), ("around", 1.0, 0.1), f32),
        (m + "out_proj", (d_inner, d), ("normal", (3 * d_inner * c["n_layer"]) ** -0.5), dt),
    ]


def _f32(w: Dict[str, torch.Tensor], fp8: bool) -> Dict[str, torch.Tensor]:
    """float32 copies; ``fp8``: the projections and embeddings (the
    matrices served in a 16-bit type) rounded to float8 first."""
    def one(k, t):
        if fp8 and t.dtype != torch.float32 and t.dim() == 2:
            return fp8_round(t)
        return t.float()
    return {k: one(k, t) for k, t in w.items()}


def _ssd(x, dt, a, bm, cm, q: int) -> torch.Tensor:
    """The state space of a batch: x (B, S, H, P), dt (B, S, H), a (H,),
    bm, cm (B, S, N) -> y (B, S, H, P) without the skip term, chunk by
    chunk: inside a chunk the causal products, the state carried across."""
    b, s, h, p = x.shape
    state = x.new_zeros((b, h, p, bm.shape[-1]))
    ys = []
    for lo in range(0, s, q):
        hi = min(s, lo + q)
        xc, dtc, bc, cc = x[:, lo:hi], dt[:, lo:hi], bm[:, lo:hi], cm[:, lo:hi]
        cum = torch.cumsum(dtc * a, dim=1)                       # (B, L, H)
        ln = hi - lo
        causal = torch.ones((ln, ln), dtype=torch.bool, device=x.device).tril()
        diff = cum[:, :, None, :] - cum[:, None, :, :]           # (B, L, L, H)
        decay = torch.exp(diff.masked_fill(~causal[None, :, :, None], float("-inf")))
        w = torch.einsum("btn,bsn->bts", cc, bc)[..., None] * decay * dtc[:, None]
        y_in = torch.einsum("btsh,bshp->bthp", w, xc)
        y_st = torch.einsum("btn,bhpn->bthp", cc, state) * torch.exp(cum)[..., None]
        ys.append(y_in + y_st)
        last = cum[:, -1]                                        # (B, H)
        wk = torch.exp(last[:, None, :] - cum) * dtc             # (B, L, H)
        state = (torch.exp(last)[..., None, None] * state
                 + torch.einsum("bsh,bshp,bsn->bhpn", wk, xc, bc))
    return torch.cat(ys, dim=1)


def _layer(c: Dict, w: Dict[str, torch.Tensor], i: int, x: torch.Tensor) -> torch.Tensor:
    """One layer over x (B, S, D)."""
    q_, m = f"layers.{i}.", f"layers.{i}.mamba."
    eps = c["norm_eps"]
    d_inner, h, p, n, conv_dim = _dims(c)
    b, s, _ = x.shape
    proj = rmsnorm(x, w[q_ + "ln.weight"], eps) @ w[m + "in_proj"]
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: d_inner + conv_dim]
    dt_raw = proj[..., d_inner + conv_dim:]
    k = c["d_conv"]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    conv = sum(padded[:, j: j + s] * w[m + "conv_w"][:, j] for j in range(k))
    xbc = F.silu(conv + w[m + "conv_b"])
    xs = xbc[..., :d_inner].reshape(b, s, h, p)
    bm, cm = xbc[..., d_inner: d_inner + n], xbc[..., d_inner + n:]
    dt = F.softplus(dt_raw + w[m + "dt_bias"])
    a = -torch.exp(w[m + "a_log"])
    y = _ssd(xs, dt, a, bm, cm, c["chunk_size"]) + w[m + "d_skip"][:, None] * xs
    y = rmsnorm(y.reshape(b, s, d_inner) * F.silu(z), w[m + "norm_w"], eps)
    return x + y @ w[m + "out_proj"]


@torch.no_grad()
def logits(c: Dict, seed: int, seqs: Sequence[torch.Tensor],
           rows: Sequence[torch.Tensor], device, fp8: bool = False) -> List[torch.Tensor]:
    """For each token sequence ``seqs[j]`` (1-D int64), the float32 logits
    ``(len(rows[j]), V)`` at its positions ``rows[j]``.  ``fp8``: the
    served matrices rounded to float8 first (the control)."""
    emb = _f32(draw_group(embed_spec(c), seed, -1, device), fp8)
    xs = [emb["embed.table"][s.to(device)][None] for s in seqs]
    for i in range(c["n_layer"]):
        w = _f32(draw_group(layer_spec(c, i), seed, i, device), fp8)
        xs = [_layer(c, w, i, x) for x in xs]
        del w
    xs = [x[0] for x in xs]
    un = emb["embed.table"].T if c["tie_embeddings"] else emb["embed.unembed"]
    return [rmsnorm(x[r.to(device)], emb["final_norm.weight"], c["norm_eps"]) @ un
            for x, r in zip(xs, rows)]


# ---------------------------------------------------------------------------
# training: the next-token loss, its gradients and AdamW, in float32
# ---------------------------------------------------------------------------

# the matrices a bf16 step computes with in bf16 (the rest stay float32)
_CAST = ("in_proj", "out_proj", "embed.table", "embed.unembed")


def _served(name: str, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """A parameter as the forward uses it: itself, or (the control) one of
    the matrices a step casts, rounded to float8, the gradient passed
    straight through."""
    if fp8 and name.endswith(_CAST):
        return w + (fp8_round(w.detach()) - w).detach()
    return w


def loss(c: Dict, params: Dict[str, torch.Tensor], tokens: torch.Tensor,
         mask: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Mean cross entropy of each next token where ``mask[:, 1:]`` is 1
    (tokens (B, S) int64, mask (B, S)): the sum over those positions over
    their count.  Each layer's activations are recomputed in the backward
    pass (``torch.utils.checkpoint``), so float32 fits."""
    from torch.utils.checkpoint import checkpoint

    table = _served("embed.table", params["embed.table"], fp8)
    x = F.embedding(tokens, table)
    for i in range(c["n_layer"]):
        names = [n for n, _, _, _ in layer_spec(c, i)]

        def run(x, *ws, i=i, names=names):
            return _layer(c, {n: _served(n, t, fp8) for n, t in zip(names, ws)}, i, x)
        x = checkpoint(run, x, *[params[n] for n in names], use_reentrant=False)
    un = table.T if c["tie_embeddings"] else _served("embed.unembed", params["embed.unembed"], fp8)
    h = rmsnorm(x[:, :-1], params["final_norm.weight"], c["norm_eps"])
    tgt, m = tokens[:, 1:], mask[:, 1:].float()
    total = h.new_zeros(())
    for lo in range(0, h.shape[1], 128):
        def nll(hc, t, mc):
            lg = hc @ un
            return torch.sum((torch.logsumexp(lg, -1)
                              - lg.gather(-1, t[..., None])[..., 0]) * mc)
        total = total + checkpoint(nll, h[:, lo:lo + 128], tgt[:, lo:lo + 128],
                                   m[:, lo:lo + 128], use_reentrant=False)
    return total / torch.clamp(m.sum(), min=1.0)


def _lr(opt: Dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine to
    ``min_lr_frac`` of it at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def train(c: Dict, seed: int, batches, opt: Dict, device, steps: int = 3,
          fp8: bool = False, half: bool = False) -> Dict:
    """``steps`` steps of AdamW from the weights drawn from the seed (float32
    masters), one batch ``(tokens, mask)`` a step: global-norm clipping,
    bias-corrected moments, decoupled decay on every parameter.  Returns
    each step's loss, each parameter's gradient norm at the first step
    (after clipping, as the optimizer takes it), and each parameter's
    change over the steps.  ``fp8``: the control's float8 forward;
    ``half``: a fault, each batch's second half left out."""
    cf = dict(c, torch_dtype="float32")
    groups = [embed_spec(cf)] + [layer_spec(cf, i) for i in range(c["n_layer"])]
    params: Dict[str, torch.Tensor] = {}
    for g, spec in enumerate(groups):
        params.update(draw_group(spec, seed, g - 1, device))
    start = {n: t.clone() for n, t in params.items()}
    for t in params.values():
        t.requires_grad_(True)
    m = {n: torch.zeros_like(t) for n, t in params.items()}
    v = {n: torch.zeros_like(t) for n, t in params.items()}
    out: Dict = {"loss": [], "grad_norm": {}, "change": {}}
    for step in range(1, steps + 1):
        tokens, mask = batches[step - 1]
        tokens, mask = tokens.to(device), mask.to(device)
        if half:
            tokens, mask = tokens[: len(tokens) // 2], mask[: len(mask) // 2]
        value = loss(c, params, tokens, mask, fp8)
        grads = torch.autograd.grad(value, list(params.values()))
        out["loss"].append(float(value.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
            scale = min(1.0, opt["grad_clip"] / (float(gnorm) + 1e-9))
            lr = _lr(opt, step)
            b1, b2 = opt["b1"], opt["b2"]
            for (n, p), g in zip(params.items(), grads):
                g = g * scale
                if step == 1:
                    out["grad_norm"][n] = float(torch.linalg.vector_norm(g))
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[n] / (1 - b1 ** step)) / (torch.sqrt(v[n] / (1 - b2 ** step)) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
        del grads
    with torch.no_grad():
        out["change"] = {n: float(torch.linalg.vector_norm(p - start[n]))
                         for n, p in params.items()}
    return out
