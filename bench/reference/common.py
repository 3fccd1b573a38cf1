"""Pieces every plain reference shares: the weights drawn from the seed,
the control's rounding to float8, and the float32 arithmetic of norms.

Imports nothing of the program.  The weights are a pure function of the
seed and the configuration: each group (the embeddings, one layer) has its
own generator on the device, seeded from ``(seed, group)``, so the harness
draws them once for the program and the reference draws each layer again
after the window, one at a time, and finds the same numbers.  Matrices are
drawn in one call a group, in the dtype they are served in.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

__all__ = ["Spec", "draw_group", "fp8_round", "rmsnorm", "set_plain_f32"]

# (name, shape, how): how is ("normal", std) for a matrix or vector drawn
# from N(0, std^2), ("around", centre, std) for centre + N(0, std^2),
# ("uniform", lo, hi), ("log_uniform", lo, hi) or ("inv_softplus_log_uniform",
# lo, hi) (x such that softplus(x) is log-uniform in [lo, hi])
Spec = List[Tuple[str, Tuple[int, ...], tuple, torch.dtype]]


def set_plain_f32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _stream(seed: int, group: int) -> int:
    return (int(seed) * 0x9E3779B1 + 7919 * (group + 2)) % (2 ** 63)


def draw_group(spec: Spec, seed: int, group: int, device) -> Dict[str, torch.Tensor]:
    """The tensors of one group, drawn from its own generator: every
    tensor of one dtype in a single ``randn`` (or ``rand``) call, then
    scaled or mapped slice by slice."""
    g = torch.Generator(device=device)
    g.manual_seed(_stream(seed, group))
    out: Dict[str, torch.Tensor] = {}
    by_dtype: Dict[Tuple[torch.dtype, bool], list] = {}
    for name, shape, how, dtype in spec:
        by_dtype.setdefault((dtype, how[0] in ("normal", "around")), []).append(
            (name, shape, how))
    for (dtype, gaussian), items in sorted(by_dtype.items(), key=lambda kv: (str(kv[0][0]), kv[0][1])):
        total = sum(math.prod(s) for _, s, _ in items)
        draw = torch.randn if gaussian else torch.rand
        flat = draw(total, generator=g, device=device, dtype=dtype)
        o = 0
        for name, shape, how in items:
            t = flat[o: o + math.prod(shape)].view(shape)
            o += math.prod(shape)
            kind = how[0]
            if kind == "normal":
                t.mul_(how[1])
            elif kind == "around":
                t.mul_(how[2]).add_(how[1])
            elif kind == "uniform":
                t.mul_(how[2] - how[1]).add_(how[1])
            elif kind in ("log_uniform", "inv_softplus_log_uniform"):
                lo, hi = math.log(how[1]), math.log(how[2])
                t.mul_(hi - lo).add_(lo).exp_()
                if kind == "inv_softplus_log_uniform":
                    t.copy_(t + torch.log(-torch.expm1(-t)))
            else:
                raise ValueError(f"unknown draw {how!r}")
            out[name] = t
    return out


def fp8_round(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 under one scale for the tensor (its
    largest magnitude to 448, the format's largest), back in float32: the
    control's weights."""
    w = w.float()
    scale = w.abs().max().clamp(min=1e-30) / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w
