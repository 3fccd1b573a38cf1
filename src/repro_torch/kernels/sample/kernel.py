"""CUDA wrapper for ``sample`` (source: ``src/repro_torch/csrc/sample.cu``).

Replaces no Pallas kernel: the reference leaves its draw,
``jax.random.categorical`` on threefry bits, to XLA's fusion inside its
jitted decode steps.  What bounds it on an H100: the operations, about 81
32-bit integer operations of threefry per logit against 2 or 4 bytes read.
Design: each row is cut into ``parts`` chunks so that ``R x parts`` blocks
fill the card at a decode batch of 8; each block leaves its first maximum
in a scratch pair, and a second launch of one warp per row picks the
first maximum of those (see the source).

:func:`sample_cuda` takes the arguments of the plain version
(``ref.sample_ref``) and gives the same ``(R,)`` int32 tokens; with
``split_key`` the new key is written by the kernel and copied into
``keys`` on the stream, so a CUDA graph captures the whole step.

``sample_cuda.launches`` counts the calls (each launches the chunk
kernel and the row reduction; thread-safe).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..build import count_launch, load
from .ref import DRAW_DTYPES

__all__ = ["PART_ELEMS", "SM_BLOCKS", "parts_for", "sample_cuda"]

PART_ELEMS = 1024   # the fewest logits a chunk takes (4 a thread)
SM_BLOCKS = 528     # 4 blocks of 256 threads per SM of an H100's 132

_FN = None


def _fn():
    global _FN
    if _FN is None:
        f = load("sample").sample_launch
        f.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        f.restype = ctypes.c_int
        _FN = f
    return _FN


def parts_for(rows: int, vocab: int) -> int:
    """Chunks per row: at least ``PART_ELEMS`` logits each, and no more
    than fill ``SM_BLOCKS`` blocks over all rows."""
    by_size = -(-vocab // PART_ELEMS)
    by_card = -(-SM_BLOCKS // max(rows, 1))
    return max(1, min(by_size, by_card))


def _u32_ptr(name: str, t: Optional[torch.Tensor], shape, dev) -> int:
    if t is None:
        return 0
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, the logits on {dev}")
    if t.dtype not in (torch.uint32, torch.int32) or tuple(t.shape) != shape:
        raise TypeError(f"{name} must be {shape} uint32 or int32, got "
                        f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def sample_cuda(logits: torch.Tensor, inv_t: float, dtype: torch.dtype, *,
                keys: Optional[torch.Tensor] = None, split_key: bool = False,
                seeds: Optional[torch.Tensor] = None,
                index: Optional[torch.Tensor] = None,
                kth: Optional[torch.Tensor] = None,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``(R, V)`` float32 or bfloat16 CUDA logits → ``(R,)`` int32 tokens;
    the arguments are :func:`~repro_torch.kernels.sample.ref.sample_ref`'s.
    ``noise``, two contiguous ``(R, V)`` tensors (int32 and float32), gets
    each element's random bits and uniform (a check's copy)."""
    dev = logits.device
    if dev.type != "cuda":
        raise ValueError(f"sample_cuda needs a CUDA tensor, got {dev}")
    if logits.dtype not in (torch.float32, torch.bfloat16) or logits.ndim != 2:
        raise TypeError(f"sample takes (R, V) float32 or bfloat16 logits, got "
                        f"{tuple(logits.shape)} {logits.dtype}")
    if dtype not in DRAW_DTYPES:
        raise TypeError(f"draws are float32 or bfloat16, not {dtype}")
    r, v = logits.shape
    if logits.stride(1) != 1:
        raise ValueError("sample_cuda needs each row's logits contiguous")
    if not 0 < v < 2**31 or r >= 2**16:
        raise ValueError(f"sample_cuda takes V < 2**31 and R < 65,536, got ({r}, {v})")
    if (seeds is None) == (keys is None) or (seeds is None) != (index is None):
        raise ValueError("sample_cuda takes keys, or seeds and index")
    per_row = keys is not None and keys.ndim == 2
    if split_key and (keys is None or per_row):
        raise ValueError("split_key splits one (2,) key")
    seeds_p = _u32_ptr("seeds", seeds, (r,), dev)
    index_p = _u32_ptr("index", index, (r,), dev)
    keys_p = _u32_ptr("keys", keys, (r, 2) if per_row else (2,), dev)
    kth_p = 0
    if kth is not None:
        if kth.dtype != torch.float32 or tuple(kth.shape) != (r,) or kth.device != dev:
            raise TypeError(f"kth must be ({r},) float32 on {dev}")
        kth = kth.contiguous()
        kth_p = kth.data_ptr()
    bits_p = unif_p = 0
    if noise is not None:
        bits, unif = noise
        if (bits.dtype, unif.dtype) != (torch.int32, torch.float32) or any(
                t.shape != (r, v) or not t.is_contiguous() or t.device != dev
                for t in noise):
            raise ValueError(f"noise must be contiguous ({r}, {v}) int32 and "
                             f"float32 tensors on {dev}")
        bits_p, unif_p = bits.data_ptr(), unif.data_ptr()
    out = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return out
    parts = parts_for(r, v)
    chunk = -(-v // parts)
    parts = -(-v // chunk)
    part_score = torch.empty((r, parts), dtype=torch.float32, device=dev)
    part_idx = torch.empty((r, parts), dtype=torch.int32, device=dev)
    key_next = (torch.empty((2,), dtype=torch.int32, device=dev) if split_key
                else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(
            logits.data_ptr(), int(logits.dtype == torch.bfloat16),
            int(dtype == torch.bfloat16), r, v, logits.stride(0), keys_p,
            2 if per_row else 0, int(split_key),
            key_next.data_ptr() if key_next is not None else 0, seeds_p, index_p,
            int(keys is not None and not per_row), float(inv_t), kth_p,
            part_score.data_ptr(), part_idx.data_ptr(), parts, chunk,
            out.data_ptr(), bits_p, unif_p, stream)
    if err != 0:
        raise RuntimeError(f"sample kernel launch failed: cudaError {err}")
    if key_next is not None:
        keys.copy_(key_next.view(keys.dtype))
    count_launch(sample_cuda)
    return out


sample_cuda.launches = 0
