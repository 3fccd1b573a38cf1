"""CUDA wrapper for ``sample`` (source: ``src/repro_torch/csrc/sample.cu``).

Replaces no Pallas kernel: the reference leaves its draw,
``jax.random.categorical`` on threefry bits with ``jax.lax.top_k``'s mask,
to XLA's fusion inside its jitted decode steps.  What bounds it on an H100:
the operations, about 81 32-bit integer operations of threefry per logit
against 2 or 4 bytes read.  Design: one launch a draw.  Each row is cut
into ``parts`` chunks so that ``R x parts`` blocks fill the card at a
decode batch of 8; each block leaves its chunk's result in a workspace and
takes a ticket on its row's arrival counter, and the last block of a row
to arrive folds the row, writes its token and zeroes the counter (see the
source).  A top-k draw with ``top_k <= TOP_K_CAP`` finds its threshold in
the same launch.

:func:`sample_cuda` takes the arguments of the plain version
(``ref.sample_ref``) and gives the same ``(R,)`` int32 tokens; with
``split_key`` the kernel writes the new key into ``keys`` itself, so a
CUDA graph captures the whole step as one kernel.

The workspace: one allocation per (device, R, chunks, listed), made by
the first draw of that shape, its counters zeroed then and never again
(every launch leaves them at zero).  Draws of one shape share it, a
graph's replays included, so they must run in turn: on one stream, or
ordered between streams (the engines draw and replay on one stream).  A
first draw inside a graph capture raises, since the zeroing would be
captured rather than run; the engines' warm-up draws before they capture.
Workspaces are never freed, since a captured graph keeps their addresses:
the set grows with the distinct shapes drawn, by about 12 bytes a block
(R x chunks blocks, fewer than ``SM_BLOCKS + R``), and by 3 KiB a block
for a top-k draw (1.6 MB at R = 8 over 262,144 logits).  ``sample_cuda``
allocates only its output.

``sample_cuda.launches`` counts the calls (each launches one kernel;
thread-safe).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import torch

from ..build import count_launch, load
from .ref import DRAW_DTYPES

__all__ = ["PART_ELEMS", "SM_BLOCKS", "TOP_K_CAP", "arrival_counters", "geometry",
           "parts_for", "sample_cuda"]

PART_ELEMS = 1024   # the fewest logits a chunk takes (4 a thread)
SM_BLOCKS = 528     # 4 blocks of 256 threads per SM of an H100's 132
TOP_K_CAP = 256     # the largest top-k whose threshold the kernel finds (kTopKCap)

_LIB = None
_WORKSPACES: Dict[tuple, torch.Tensor] = {}
_WS_LOCK = threading.Lock()
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _lib():
    global _LIB
    if _LIB is None:
        lib = load("sample")
        lib.sample_launch.argtypes = [
            _P, _I, _I, _I, _I, _LL, _P, _I, _I, _P, _P, _I, _F, _P, _I, _P, _LL,
            _I, _I, _P, _P, _P, _P,
        ]
        lib.sample_launch.restype = _I
        lib.sample_workspace_bytes.argtypes = [_I, _I, _I]
        lib.sample_workspace_bytes.restype = _LL
        lib.sample_top_k_cap.restype = _I
        if lib.sample_top_k_cap() != TOP_K_CAP:
            raise RuntimeError(f"csrc/sample.cu finds thresholds up to top_k = "
                               f"{lib.sample_top_k_cap()}, TOP_K_CAP is {TOP_K_CAP}")
        _LIB = lib
    return _LIB


def parts_for(rows: int, vocab: int) -> int:
    """Chunks per row: at least ``PART_ELEMS`` logits each, and no more
    than fill ``SM_BLOCKS`` blocks over all rows."""
    by_size = -(-vocab // PART_ELEMS)
    by_card = -(-SM_BLOCKS // max(rows, 1))
    return max(1, min(by_size, by_card))


def geometry(rows: int, vocab: int) -> Tuple[int, int]:
    """``(chunks, chunk)`` of a draw: ``chunk`` logits a block, the last
    chunk ragged, no chunk empty."""
    chunk = -(-vocab // parts_for(rows, vocab))
    return -(-vocab // chunk), chunk


def _workspace(dev: torch.device, r: int, parts: int, listed: bool) -> torch.Tensor:
    """The draw's workspace, made (counters zeroed) by the first draw of
    its shape, which must not be captured."""
    key = (dev.index, r, parts, listed)
    ws = _WORKSPACES.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "sample_cuda: the first draw of this shape is being captured; draw "
                "once before capturing, so that the workspace's counters are zeroed "
                "outside the graph")
        with _WS_LOCK:
            ws = _WORKSPACES.get(key)
            if ws is None:
                nbytes = _lib().sample_workspace_bytes(r, parts, int(listed))
                ws = _WORKSPACES[key] = torch.zeros(nbytes, dtype=torch.uint8,
                                                    device=dev)
    return ws


def arrival_counters() -> List[torch.Tensor]:
    """Every workspace's ``(R + 1,)`` int32 arrival counters (each row's,
    then the rows folded in a split-key draw): all zero between launches."""
    return [ws[: 4 * (key[1] + 1)].view(torch.int32)
            for key, ws in list(_WORKSPACES.items())]


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
                kth: Optional[torch.Tensor] = None, top_k: int = 0,
                noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """``(R, V)`` float32 or bfloat16 CUDA logits → ``(R,)`` int32 tokens;
    the arguments are :func:`~repro_torch.kernels.sample.ref.sample_ref`'s,
    and ``top_k``: the kernel masks each row's logits below its ``top_k``-th
    largest scaled logit, found in the same launch (``0 < top_k <=
    TOP_K_CAP``; ``top_k >= V`` masks nothing), in place of a given
    ``kth``.  ``noise``, two contiguous ``(R, V)`` tensors (int32 and
    float32), gets each element's random bits and uniform (a check's
    copy)."""
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
    if top_k < 0 or TOP_K_CAP < top_k < v:
        raise ValueError(f"sample_cuda finds the threshold of top_k <= {TOP_K_CAP}, "
                         f"got {top_k}: pass its kth")
    if top_k >= v:
        top_k = 0
    if top_k and kth is not None:
        raise ValueError("sample_cuda takes top_k or kth, not both")
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
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return sample_cuda(logits, inv_t, dtype, keys=keys, split_key=split_key,
                               seeds=seeds, index=index, kth=kth, top_k=top_k,
                               noise=noise)
    out = torch.empty((r,), dtype=torch.int32, device=dev)
    if r == 0:
        return out
    parts, chunk = geometry(r, v)
    ws = _workspace(dev, r, parts, top_k > 0)
    err = _lib().sample_launch(
        logits.data_ptr(), int(logits.dtype == torch.bfloat16),
        int(dtype == torch.bfloat16), r, v, logits.stride(0), keys_p,
        2 if per_row else 0, int(split_key), seeds_p, index_p,
        int(keys is not None and not per_row), float(inv_t), kth_p, top_k,
        ws.data_ptr(), ws.numel(), parts, chunk, out.data_ptr(), bits_p, unif_p,
        torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"sample kernel launch failed: cudaError {err}")
    count_launch(sample_cuda)
    return out


sample_cuda.launches = 0
