"""CUDA wrapper for ``hash_mix`` (source: ``src/repro_torch/csrc/hash_mix.cu``).

Replaces the Pallas kernel ``hash_mix_pallas`` / ``_hash_mix_kernel`` of
``src/repro/kernels/hash_mix/kernel.py``.  What bounds it on an H100: the
bytes — ``N * (4W + 16)`` moved against about 15 integer instructions per
4-byte lane.  One thread mixes one row (the mix is sequential over lanes).
:func:`route` picks one of two kernels before launch, from the width and
the base address alone (never after a failure):

* ``"staged"`` (``W`` in ``STAGED_WIDTHS``, a 16-byte aligned base): a
  persistent grid whose blocks copy tiles of 128 rows into shared memory,
  32 lanes of each row at a time, by coalesced 16-byte ``cp.async`` copies
  through a 2-chunk ring, and mix each row from there (padded rows, free
  of bank conflicts); the lane loop is unrolled and the width a template
  constant.
* ``"rowwise"``: any other width or alignment (a contiguous view that
  starts 4 bytes off 16-byte alignment, say): one thread walks its row
  with 4-byte loads.

``hash_mix_cuda.launches`` counts the launches of either kernel,
``staged_launches`` and ``rowwise_launches`` those of each route
(thread-safe).
"""

from __future__ import annotations

import ctypes

import torch

from ..build import count_launch, load

__all__ = ["ROUTES", "STAGED_WIDTHS", "hash_mix_cuda", "launch", "route"]

ROUTES = ("staged", "rowwise")
# the widths compare_ids_batch buckets lanes to (powers of two from 32)
STAGED_WIDTHS = (32, 64, 128, 256)
STAGED_ALIGN = 16  # bytes: cp.async copies 16-byte pieces

_FNS = {}


def _fn(path: str):
    f = _FNS.get(path)
    if f is None:
        lib = load("hash_mix")
        f = lib.hash_mix_staged_launch if path == "staged" else lib.hash_mix_launch
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _FNS[path] = f
    return f


def launch(path: str, x: torch.Tensor, out: torch.Tensor, seed: int) -> None:
    """Launch route ``path``'s kernel on checked inputs into ``out``.
    Raises if the launch fails."""
    n, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(path)(x.data_ptr(), out.data_ptr(), n, w, seed, stream)
    if err != 0:
        raise RuntimeError(f"hash_mix {path} kernel launch failed: cudaError {err}")


def route(w: int, data_ptr: int) -> str:
    """``"staged"`` or ``"rowwise"``: which kernel mixes contiguous rows of
    ``w`` lanes starting at address ``data_ptr``."""
    if w in STAGED_WIDTHS and data_ptr % STAGED_ALIGN == 0:
        return "staged"
    return "rowwise"


def hash_mix_cuda(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """``(N, W)`` uint32 CUDA tensor → ``(N, 4)`` uint32 digests."""
    if x.device.type != "cuda":
        raise ValueError(f"hash_mix_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.uint32 or x.ndim != 2:
        raise TypeError(
            f"hash_mix expects (N, W) uint32, got {tuple(x.shape)} {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("hash_mix_cuda needs a contiguous (N, W) tensor")
    n, w = x.shape
    if not 0 <= seed < 2**32:
        raise ValueError(f"seed must fit in 32 bits, got {seed}")
    out = torch.empty((n, 4), dtype=torch.uint32, device=x.device)
    if n == 0:
        return out
    path = route(w, x.data_ptr())
    launch(path, x, out, seed)
    count_launch(hash_mix_cuda, "launches", f"{path}_launches")
    return out


hash_mix_cuda.launches = 0
hash_mix_cuda.staged_launches = 0
hash_mix_cuda.rowwise_launches = 0
