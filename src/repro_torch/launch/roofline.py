"""Roofline terms of the port's dry-run, with the H100's constants (the
reference's ``launch/roofline.py``).

Three terms per (arch × shape × mesh), in seconds, all per device:

  compute    = FLOPs_per_device      / peak FLOP/s   (989 TF bf16 per GPU)
  memory     = bytes_per_device      / HBM bandwidth (3.35 TB/s per GPU)
  collective = Σ over mesh axes of that axis's collective bytes / the
               bandwidth of the links it crosses ("model" inside an 8-GPU
               NVLink node, the data and pod axes across nodes)

The reference reads FLOPs and bytes from XLA's ``cost_analysis`` and the
collectives from the optimized HLO.  The port has neither: the dry-run
(``launch/dryrun.py``) runs the cell's step once on ``meta`` tensors over
a fake process group and counts each rank's **local** work as it goes
(:class:`LocalCost`): the FLOPs of every matmul-like op from
``torch.utils.flop_counter``'s table (the one ``FlopCounterMode`` uses),
the bytes each op reads and writes, the work of every hand-written kernel
from ``kernels/work.py`` (their ``meta`` branches count it), and the
operand bytes of every collective that DTensor issues, by kind and by
mesh axis.  ``CommDebugMode`` counts the same collectives (it records
counts, not bytes); the dry-run checks that the two agree.

An eager op reads its inputs from and writes its output to memory, so
the bytes term is that of the program as the port runs it, unfused: it is
the analogue of XLA's "bytes accessed" after fusion only where an op is a
kernel of its own, and larger elsewhere.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.work import attention_work, scan_work, visible_pairs

__all__ = [
    "HW",
    "LocalCost",
    "RooflineTerms",
    "attention_work",
    "model_flops",
    "scan_work",
    "visible_pairs",
]


class HW:
    """Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates."""

    PEAK_FLOPS = 989e12   # bf16 tensor cores, no sparsity (NVIDIA H100 data sheet)
    HBM_BW = 3.35e12      # bytes/s of HBM3 (NVIDIA H100 data sheet)
    # NVLink 4: 18 links of 25 GB/s each way, 450 GB/s per direction
    # (900 GB/s bidirectional; NVIDIA H100 data sheet)
    NVLINK_BW = 450e9
    # across nodes: one 400 Gb/s NDR InfiniBand port per GPU (ConnectX-7,
    # NVIDIA DGX H100 system guide) = 50 GB/s per direction
    NET_BW = 50e9
    # a collective whose mesh axis is not known is priced at the slower link
    ICI_BW = NET_BW
    # the axes whose collectives stay inside one node
    NVLINK_AXES = ("model",)

    @classmethod
    def link_bw(cls, axis: str) -> float:
        """Bytes/s a collective over mesh axis ``axis`` moves per GPU."""
        return cls.NVLINK_BW if axis in cls.NVLINK_AXES else cls.NET_BW


COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# DTensor's functional collectives → the reference's HLO names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    collective_breakdown: Dict[str, int]
    peak_memory_bytes: float
    # collective bytes per mesh axis; empty: every byte at HW.ICI_BW
    collective_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / HW.PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        if not self.collective_by_axis:
            return self.collective_bytes / HW.ICI_BW
        return sum(b / HW.link_bw(a) for a, b in self.collective_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Roofline lower bound on step time (terms fully overlapped)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes": self.collective_bytes,
            "collective_breakdown": self.collective_breakdown,
            "peak_memory_bytes": self.peak_memory_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time_lb,
        }


def model_flops(n_params_active: int, n_tokens: int, kind: str = "train") -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference forward)."""
    per_tok = 6 if kind == "train" else 2
    return float(per_tok) * n_params_active * n_tokens


_SHARDING_PROP = os.sep + "_sharding_prop.py"


def _in_sharding_propagation() -> bool:
    """True while DTensor propagates shapes: it runs the op once on
    global-shape stand-ins, which no device executes."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return True
        f = f.f_back
    return False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class LocalCost(TorchDispatchMode):
    """Counts one rank's local work (see the module docstring): it defers
    every op on DTensors to DTensor (returns NotImplemented) and counts the
    plain-tensor ops DTensor runs on this rank's shards, leaving out those
    of DTensor's shape propagation.  ``group_axes`` maps a process group's
    name to its mesh axis."""

    def __init__(self, group_axes: Dict[str, str]):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        self._dtensor = DTensor
        self._flops_of = flop_registry
        self.group_axes = dict(group_axes)
        self.flops = 0
        self.bytes = 0
        self.collective_breakdown: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.collective_by_axis: Dict[str, int] = defaultdict(int)
        self.collective_calls = 0
        self.flops_by_op: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_sharding_propagation():
            return out
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "_c10d_functional":
            kind = _KINDS.get(packet.__name__)
            if kind is not None:
                nbytes = _nbytes(args[0])
                group = next((a for a in reversed(args) if isinstance(a, str)), "")
                self.collective_breakdown[kind] = (
                    self.collective_breakdown.get(kind, 0) + nbytes)
                self.collective_by_axis[self.group_axes.get(group, "?")] += nbytes
                self.collective_calls += 1
            return out
        count = self._flops_of.get(packet)
        if count is not None:
            f = int(count(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_op[str(packet)] += f
        if func.is_view or packet.__name__.startswith(("empty", "_local_scalar")):
            return out
        self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out

    def terms(self, kernels: Dict[str, Dict[str, int]],
              peak_memory_bytes: float = 0.0) -> RooflineTerms:
        """The counted work plus the kernels' (``kernels.work.counting``)."""
        flops = self.flops + sum(k["flops"] for k in kernels.values())
        nbytes = self.bytes + sum(k["bytes"] for k in kernels.values())
        coll = {k: int(v) for k, v in self.collective_breakdown.items()}
        return RooflineTerms(
            flops_per_device=float(flops),
            bytes_per_device=float(nbytes),
            collective_bytes=float(sum(coll.values())),
            collective_breakdown=coll,
            peak_memory_bytes=float(peak_memory_bytes),
            collective_by_axis={a: float(b) for a, b in self.collective_by_axis.items()},
        )
