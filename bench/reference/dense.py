"""Plain float32 reference of a dense GQA decoder (the LLaMA layout that
yi-6b publishes): RMSNorm, rotary embeddings on half-split heads, causal
grouped-query attention (query head h reads key/value head h // G),
SwiGLU, untied unembedding.

Computed layer by layer: each layer's weights are drawn again from the
seed (``common.draw_group``), cast to float32 (or rounded to float8 for
the control) and applied to every sequence before the next layer is
drawn, so float32 fits beside nothing else of the model.  Attention runs
in blocks of query rows.  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from reference.common import Spec, draw_group, fp8_round, rmsnorm

__all__ = ["PORT_FIELDS", "embed_spec", "layer_spec", "logits", "n_groups"]

# configuration file key -> the port's ModelConfig field
PORT_FIELDS = {
    "hidden_size": "d_model", "num_hidden_layers": "n_layers",
    "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
    "head_dim": "head_dim", "intermediate_size": "d_ff",
    "vocab_size": "vocab_size", "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype",
}

_DT = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_ROWS = 512   # query rows an attention block takes


def n_groups(c: Dict) -> int:
    """Weight groups: the embeddings (group -1) and one a layer."""
    return c["num_hidden_layers"]


def embed_spec(c: Dict) -> Spec:
    dt = _DT[c["torch_dtype"]]
    v, d = c["vocab_size"], c["hidden_size"]
    spec = [("embed.table", (v, d), ("normal", 0.02), dt)]
    if not c["tie_word_embeddings"]:
        spec.append(("embed.unembed", (d, v), ("normal", 0.02), dt))
    spec.append(("final_norm.weight", (d,), ("around", 1.0, 0.1), torch.float32))
    return spec


def layer_spec(c: Dict, i: int) -> Spec:
    """One layer's tensors: matrices N(0, initializer_range^2) where the
    file states one (the published initialisation), else N(0, 1/fan_in)."""
    dt = _DT[c["torch_dtype"]]
    d, h, hkv, dh, f = (c["hidden_size"], c["num_attention_heads"],
                        c["num_key_value_heads"], c["head_dim"],
                        c["intermediate_size"])
    std = c.get("initializer_range")
    p = f"layers.{i}."

    def mat(fan_in):
        return ("normal", std if std else fan_in ** -0.5)

    return [
        (p + "ln1.weight", (d,), ("around", 1.0, 0.1), torch.float32),
        (p + "attn.wq", (d, h * dh), mat(d), dt),
        (p + "attn.wk", (d, hkv * dh), mat(d), dt),
        (p + "attn.wv", (d, hkv * dh), mat(d), dt),
        (p + "attn.wo", (h * dh, d), mat(h * dh), dt),
        (p + "ln2.weight", (d,), ("around", 1.0, 0.1), torch.float32),
        (p + "mlp.wg", (d, f), mat(d), dt),
        (p + "mlp.wu", (d, f), mat(d), dt),
        (p + "mlp.wd", (f, d), mat(f), dt),
    ]


def _f32(w: Dict[str, torch.Tensor], fp8: bool) -> Dict[str, torch.Tensor]:
    return {k: (fp8_round(t) if fp8 and t.dim() == 2 else t.float())
            for k, t in w.items()}


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, Dh): rotate the two halves of each head by position."""
    s, dh = x.shape[0], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                          device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v) -> torch.Tensor:
    """Causal GQA: q (S, H, Dh), k, v (S, Hkv, Dh) -> (S, H * Dh)."""
    s, h, dh = q.shape
    hkv = k.shape[1]
    qg = q.permute(1, 0, 2).reshape(hkv, h // hkv, s, dh)
    kt = k.permute(1, 2, 0)[:, None]            # (Hkv, 1, Dh, S)
    vv = v.permute(1, 0, 2)[:, None]            # (Hkv, 1, S, Dh)
    out = torch.empty((hkv, h // hkv, s, dh), dtype=q.dtype, device=q.device)
    keys = torch.arange(s, device=q.device)
    for lo in range(0, s, _ROWS):
        hi = min(s, lo + _ROWS)
        sc = (qg[:, :, lo:hi] @ kt[..., :hi]) / math.sqrt(dh)
        mask = keys[None, :hi] > torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(mask, float("-inf"))
        out[:, :, lo:hi] = torch.softmax(sc, dim=-1) @ vv[:, :, :hi]
    return out.reshape(h, s, dh).permute(1, 0, 2).reshape(s, h * dh)


def _layer(c: Dict, w: Dict[str, torch.Tensor], i: int, x: torch.Tensor) -> torch.Tensor:
    p = f"layers.{i}."
    eps = c["rms_norm_eps"]
    h, hkv, dh = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
    s = x.shape[0]
    a = rmsnorm(x, w[p + "ln1.weight"], eps)
    q = _rope((a @ w[p + "attn.wq"]).view(s, h, dh), c["rope_theta"])
    k = _rope((a @ w[p + "attn.wk"]).view(s, hkv, dh), c["rope_theta"])
    v = (a @ w[p + "attn.wv"]).view(s, hkv, dh)
    x = x + _attention(q, k, v) @ w[p + "attn.wo"]
    m = rmsnorm(x, w[p + "ln2.weight"], eps)
    return x + (F.silu(m @ w[p + "mlp.wg"]) * (m @ w[p + "mlp.wu"])) @ w[p + "mlp.wd"]


@torch.no_grad()
def logits(c: Dict, seed: int, seqs: Sequence[torch.Tensor],
           rows: Sequence[torch.Tensor], device, fp8: bool = False) -> List[torch.Tensor]:
    """For each token sequence ``seqs[j]`` (1-D int64), the float32 logits
    ``(len(rows[j]), V)`` at its positions ``rows[j]``, the whole sequence
    attended causally.  ``fp8``: every matrix rounded to float8 first (the
    control)."""
    emb = _f32(draw_group(embed_spec(c), seed, -1, device), fp8)
    xs = [emb["embed.table"][s.to(device)] for s in seqs]
    for i in range(c["num_hidden_layers"]):
        w = _f32(draw_group(layer_spec(c, i), seed, i, device), fp8)
        xs = [_layer(c, w, i, x) for x in xs]
        del w
    un = emb["embed.table"].T if c["tie_word_embeddings"] else emb["embed.unembed"]
    eps = c["rms_norm_eps"]
    return [rmsnorm(x[r.to(device)], emb["final_norm.weight"], eps) @ un
            for x, r in zip(xs, rows)]
