"""Plain PyTorch version of the ``hash_mix`` kernel.

128-bit mixing hash (xxhash/murmur-flavoured avalanche) over packed
``(N, W)`` uint32 identifier tensors, emitted as ``(N, 4)`` uint32 lanes —
the same function as the reference package's ``hash_mix_ref``, bit for bit.

PyTorch implements few operators for ``uint32`` (on the CPU only ``*``,
``^`` and ``&``), so this version widens to int64 and keeps every value in
``[0, 2**32)`` with ``& 0xFFFFFFFF``.  A 32x32-bit product would pass
2**63, so :func:`_mul32` splits the constant into 16-bit halves: no
intermediate exceeds 2**49.  Runs on any device; the CPU tests use it,
and on the card it is the yardstick the CUDA kernel is held to.
"""

from __future__ import annotations

import torch

__all__ = ["hash_mix_ref", "PRIME1", "PRIME2", "PRIME3", "PRIME4"]

# xxhash32 primes (odd, high-entropy) — standard public constants.
PRIME1 = 0x9E3779B1
PRIME2 = 0x85EBCA77
PRIME3 = 0xC2B2AE3D
PRIME4 = 0x27D4EB2F

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant ``c``."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 15)
    h = _mul32(h, PRIME2)
    h = h ^ (h >> 13)
    h = _mul32(h, PRIME3)
    h = h ^ (h >> 16)
    return h


def to_u32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → the same bits as a uint32 tensor."""
    signed = torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)
    return signed.view(torch.uint32)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor → int64 values in [0, 2**32) (through an int32 view,
    which every device's kernels support)."""
    return x.view(torch.int32).to(torch.int64) & _M32


def hash_mix_ref(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``(N, W) uint32 → (N, 4) uint32`` 128-bit mixing digest."""
    if x.dtype != torch.uint32:
        raise TypeError(f"hash_mix expects uint32, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"hash_mix expects (N, W), got {tuple(x.shape)}")
    n, w = x.shape
    s = seed & _M32
    xv = from_u32(x.contiguous())

    def full(v: int) -> torch.Tensor:
        return torch.full((n,), v & _M32, dtype=torch.int64, device=x.device)

    h0 = full(PRIME1 + s)
    h1 = full(PRIME2 ^ s)
    h2 = full(PRIME3 + ((s * PRIME1) & _M32))
    h3 = full(PRIME4 ^ ((s * PRIME2) & _M32))
    for i in range(w):
        k = xv[:, i]
        lane = i + 1
        h0 = _mul32(_rotl((h0 + _mul32(k, PRIME2)) & _M32, 13), PRIME1)
        h1 = _mul32(_rotl(h1 ^ _mul32((k + lane) & _M32, PRIME3), 17), PRIME2)
        kl = k ^ ((lane * PRIME1) & _M32)
        h2 = _mul32(_rotl((h2 + _mul32(kl, PRIME4)) & _M32, 11), PRIME3)
        h3 = _mul32(_rotl(h3 ^ _mul32(k, PRIME1), 19), PRIME4)
    # length injection + cross-lane mix + final avalanche
    ln = w
    h0 = _avalanche(h0 ^ ((ln * PRIME1) & _M32) ^ _rotl(h1, 7))
    h1 = _avalanche(h1 ^ ((ln * PRIME2) & _M32) ^ _rotl(h2, 12))
    h2 = _avalanche(h2 ^ ((ln * PRIME3) & _M32) ^ _rotl(h3, 18))
    h3 = _avalanche(h3 ^ ((ln * PRIME4) & _M32) ^ _rotl(h0, 23))
    return to_u32(torch.stack([h0, h1, h2, h3], dim=1))
