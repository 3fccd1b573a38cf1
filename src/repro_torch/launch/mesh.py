"""Mesh construction of the port (the reference's ``launch/mesh.py`` on
``torch.distributed``'s DeviceMesh).

Functions, not module-level constants: importing this module touches no
process group and no device.

The process group behind a mesh is NCCL for a CUDA mesh and gloo for a
CPU one.  :func:`make_mesh` initialises it when no group exists yet: from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``; ``LOCAL_RANK`` picks the card), or, in a process that
was started alone, as a group of one over an in-memory store.  A mesh of
more than one device therefore runs under ``torchrun --nproc-per-node N``
(or any launcher that sets those variables), and a mesh whose size is not
the group's world size raises.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

__all__ = [
    "dp_axes",
    "ensure_process_group",
    "make_mesh",
    "make_production_mesh",
    "mesh_from_str",
]


def ensure_process_group(device_type: str = "cuda") -> None:
    """Initialise the default process group for a ``device_type`` mesh if
    there is none: NCCL on ``"cuda"``, gloo on ``"cpu"``; torchrun's
    environment when it is set, else one rank over a ``HashStore``."""
    if dist.is_initialized():
        return
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA mesh was requested but CUDA is not available; pass "
                "device='cpu' for a gloo mesh on the host")
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported mesh device {device_type!r} (cuda or cpu)")
    if backend == "nccl":   # the card of this process, before the group
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 torch.cuda.current_device())))
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device: str = "cuda"):
    """A DeviceMesh of ``shape`` named ``axes`` over the default process
    group (initialised here if needed, see :func:`ensure_process_group`).
    Its size must be the group's world size."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} / axes {axes} mismatch")
    device_type = torch.device(device).type
    ensure_process_group(device_type)
    size = 1
    for n in shape:
        size *= n
    world = dist.get_world_size()
    if size != world:
        raise ValueError(
            f"a {'x'.join(map(str, shape))} mesh needs {size} ranks, the "
            f"process group has {world} (run under torchrun --nproc-per-node "
            f"{size})")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """The production layouts: 256 GPUs as ``("data", "model") = (32, 8)``,
    or 512 as ``("pod", "data", "model") = (2, 32, 8)``.

    The reference lays the same 256 and 512 devices out as one 16 × 16 TPU
    pod (and two of them).  An H100 cluster is built of 8-GPU nodes joined
    by NVLink inside and by InfiniBand across, so "model" (tensor
    parallelism, whose collectives run every layer) is 8 wide and stays
    inside one node; a 16-wide "model" axis would put them across nodes.
    The data axis spans the 32 nodes of a pod.
    """
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def mesh_from_str(spec: str, device: str = "cuda"):
    """``"DATAxMODEL"`` → mesh, or None for the 1-device ``"1x1"`` case.

    The launchers' shared CLI surface: validates the shape string so a
    typo fails with the expected format instead of an unpack traceback.
    """
    parts = spec.lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(f"bad mesh {spec!r}; expected DATAxMODEL, e.g. 2x4")
    d, m = int(parts[0]), int(parts[1])
    if d < 1 or m < 1:
        raise ValueError(f"bad mesh {spec!r}; extents must be >= 1")
    if d * m == 1:
        return None
    return make_mesh((d, m), ("data", "model"), device=device)


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of a mesh (everything except 'model')."""
    from ..dist.logical import mesh_axis_names

    return tuple(a for a in mesh_axis_names(mesh) if a != "model")

