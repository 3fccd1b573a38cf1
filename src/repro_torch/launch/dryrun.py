"""Dry-run of the port: every (arch × shape × mesh) cell's step, run once
on ``meta`` tensors over a fake process group, counted, allocating nothing
(the reference's ``launch/dryrun.py``).

For each cell: a fake process group of the mesh's size
(``torch.testing._internal.distributed.fake_pg``, imported here only:
``import repro_torch`` never pulls in ``torch.testing``), the production
mesh (32×8 single-pod, 2×32×8 multi-pod, ``launch/mesh.py``) or any
``--mesh``, the model, its train state or cache and the inputs built on
``meta`` (``device.construct_on_meta``) and laid out as DTensors by the
models' logical specs (``launch/sharding.py``).  :func:`lower_cell` also
takes a cell of its own shape and any mesh shape (``chip_smoke.py`` holds
1-rank cells against the card's measured times).  Then the cell's step —
the train step (loss, backward, AdamW), the prefill or one decode step —
runs once under ``roofline.LocalCost`` and ``CommDebugMode``, with the
kernels' ``meta`` branches counting their own work (``kernels/work.py``).
A fake group moves no data, so the collectives cost nothing but their
count and their bytes.

The meta run executes every layer, so the reference's 1- and 2-block
probe compiles and their extrapolation (XLA counts a while loop's body
once) are not needed: the counts are those of the whole depth.

Memory: XLA's ``memory_analysis`` gives the arguments' and the
temporaries' bytes of the compiled program.  An eager program has no
such plan (its temporaries come and go op by op through the caching
allocator), so the record gives the per-device argument bytes — the local
shards of the parameters, the optimizer state or the cache, and the
inputs — and ``temp_bytes_per_device`` null.

Usage::

  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--both-meshes] --out runs/dryrun.jsonl

Records are JSON lines with the reference's keys (``arch``, ``shape``,
``mesh``, ``status``, ``roofline``, ``params_total`` ...); a cell that
``cell_is_runnable`` refuses is ``status: "skipped"`` with its reason.
``launch/report.py`` renders them.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from ..configs import ARCH_NAMES, SHAPES, cell_is_runnable, get_config, shape_by_name
from ..configs.base import ShapeConfig
from ..device import construct_on_meta
from ..dist.logical import use_mesh
from ..kernels import work
from ..models.registry import build_model
from ..models.specs import cache_specs, param_specs
from ..train.loop import make_train_state, make_train_step
from ..train.optimizer import AdamWConfig
from .mesh import make_mesh
from .roofline import LocalCost, model_flops
from .sharding import (
    batch_shardings,
    distribute,
    distribute_params,
    distribute_tree,
    shardings_from_specs,
)

__all__ = ["build_cell", "lower_cell", "main", "param_stats", "production_mesh_shape"]


def production_mesh_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``launch.mesh.make_production_mesh``'s shape and axes."""
    if multi_pod:
        return (2, 32, 8), ("pod", "data", "model")
    return (32, 8), ("data", "model")


def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A CPU DeviceMesh of ``shape`` on a fake process group of its size
    (rank 0; the group is re-made when the size changes).  A group of
    another backend already in this process raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = 1
    for n in shape:
        size *= n
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"the dry-run needs a fake process group; this process already "
                f"has a {dist.get_backend()} one (destroy it first)")
        if dist.get_world_size() != size:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    return make_mesh(shape, axes, device="cpu")


def param_stats(model: torch.nn.Module, specs: Dict[str, tuple]) -> dict:
    """``{"total", "expert"}`` parameter elements (whole tensors); the
    expert ones are those whose spec names "experts"."""
    total = expert = 0
    for name, p in model.named_parameters():
        total += p.numel()
        if "experts" in specs[name]:
            expert += p.numel()
    return {"total": int(total), "expert": int(expert)}


def _local_devices(tree) -> set:
    if isinstance(tree, torch.Tensor):
        return {(tree.to_local() if hasattr(tree, "to_local") else tree).device.type}
    if isinstance(tree, dict):
        return set().union(*map(_local_devices, tree.values()))
    if isinstance(tree, (list, tuple)):
        return set().union(*map(_local_devices, tree))
    if isinstance(tree, torch.nn.Module):
        return set().union(*map(_local_devices, tree.parameters()))
    return set()


def _local_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        local = tree.to_local() if hasattr(tree, "to_local") else tree
        return local.numel() * local.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    return 0


def _inputs(cfg, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """The reference's ``input_specs`` as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    if shape.kind in ("train", "prefill"):
        s_txt = s - (cfg.n_img_tokens or 0)
        out = {"tokens": torch.empty((b, s_txt), dtype=torch.long, **meta)}
        if shape.kind == "train":
            out["loss_mask"] = torch.empty((b, s_txt), dtype=torch.float32, **meta)
        if cfg.family == "encdec":
            out["frames"] = torch.empty((b, cfg.enc_frames, cfg.d_model),
                                        dtype=torch.float32, **meta)
        if cfg.family == "vlm":
            out["patch_embeds"] = torch.empty((b, cfg.n_img_tokens, cfg.d_model),
                                              dtype=torch.float32, **meta)
        return out
    return {"token": torch.empty((b, 1), dtype=torch.long, **meta),
            "pos": torch.empty((b,), dtype=torch.long, **meta)}


def build_cell(cfg, shape: ShapeConfig, mesh):
    """The cell's model (or train state), cache and inputs on ``meta``,
    laid out over ``mesh`` → ``(step, its arguments, param stats, argument
    bytes per device)``; ``step(*args)`` runs the cell once."""
    api = build_model(cfg)
    g = torch.Generator()
    with construct_on_meta():
        if shape.kind == "train":
            state = make_train_state(api, g, AdamWConfig(), "cpu")
            model = state["model"]
        else:
            model = api.init(g, "cpu")
    specs = param_specs(model)
    stats = param_stats(model, specs)
    distribute_params(model, mesh, specs)
    inputs = _inputs(cfg, shape)
    pls = batch_shardings(mesh, inputs)
    inputs = {k: distribute(v, mesh, pls[k]) for k, v in inputs.items()}

    if shape.kind == "train":
        from ..train.optimizer import adamw_init

        state["opt"] = adamw_init(dict(model.named_parameters()), AdamWConfig())
        step_fn = make_train_step(api, AdamWConfig())
        args = (state, inputs)
        arg_bytes = _local_bytes(model) + _local_bytes(state["opt"]) + _local_bytes(inputs)
        return step_fn, args, stats, arg_bytes
    if shape.kind == "prefill":
        def prefill(m, batch):
            return api.prefill(m, batch, max_len=shape.seq_len)

        return prefill, (model, inputs), stats, _local_bytes(model) + _local_bytes(inputs)
    with construct_on_meta():
        cache = api.cache_init(shape.global_batch, shape.seq_len, "cpu")
    cache = distribute_tree(cache, mesh, shardings_from_specs(mesh, cache_specs(cache),
                                                              cache))

    def decode(m, token, pos, c):
        return api.decode_step(m, token, pos, c)

    args = (model, inputs["token"], inputs["pos"], cache)
    arg_bytes = _local_bytes(model) + _local_bytes(inputs) + _local_bytes(cache)
    return decode, args, stats, arg_bytes


def _group_axes(mesh) -> Dict[str, str]:
    return {mesh.get_group(a).group_name: a for a in mesh.mesh_dim_names}


def lower_cell(arch: str, shape, mesh_shape: Tuple[int, ...], axes: Tuple[str, ...],
               verbose: bool = True) -> dict:
    """Count one cell → its record.  ``shape`` is a ``ShapeConfig`` or a
    name of ``SHAPES``."""
    from torch.distributed.tensor.debug import CommDebugMode

    cfg = get_config(arch)
    shape = shape_by_name(shape) if isinstance(shape, str) else shape
    mesh_name = "x".join(map(str, mesh_shape))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name}
    if not cell_is_runnable(cfg, shape):
        rec.update(status="skipped", reason=cfg.notes)
        if verbose:
            print(f"[{mesh_name}] {arch} × {shape.name}: SKIPPED ({cfg.notes})")
        return rec

    t0 = time.perf_counter()
    mesh = fake_mesh(mesh_shape, axes)
    step, args, pstats, arg_bytes = build_cell(cfg, shape, mesh)
    devices = sorted(_local_devices(args))   # ["meta"]: nothing allocated
    t_build = time.perf_counter() - t0
    grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
    with use_mesh(mesh), CommDebugMode() as comm, LocalCost(_group_axes(mesh)) as cost, \
            work.counting() as kernels, grad:
        step(*args)
    t_run = time.perf_counter() - t0 - t_build
    del args
    comm_calls = int(comm.get_total_counts())
    if comm_calls != cost.collective_calls:
        raise RuntimeError(f"{arch} × {shape.name}: CommDebugMode counted "
                           f"{comm_calls} collectives, the cost mode "
                           f"{cost.collective_calls}")
    terms = cost.terms(kernels, peak_memory_bytes=arg_bytes)

    n_chips = mesh.size()
    n_active = pstats["total"] - pstats["expert"] + (
        pstats["expert"] * cfg.experts_per_token // max(cfg.n_experts, 1))
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(n_active, tokens, "train")
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mf = model_flops(n_active, tokens, "inference")
    else:
        tokens = shape.global_batch
        mf = model_flops(n_active, tokens, "inference")
    rec.update(
        status="ok",
        n_chips=n_chips,
        params_total=pstats["total"],
        params_active=int(n_active),
        tokens_per_step=int(tokens),
        lower_s=round(t_build, 2),
        compile_s=None,                  # nothing is compiled: eager
        run_s=round(t_run, 2),
        total_s=round(time.perf_counter() - t0, 2),
        arg_bytes_per_device=int(arg_bytes),
        arg_devices=devices,
        temp_bytes_per_device=None,      # no counterpart (module docstring)
        model_flops_global=mf,
        model_flops_per_device=mf / n_chips,
        roofline=terms.as_dict(),
        collective_by_axis=terms.collective_by_axis,
        collective_calls=comm_calls,
        kernels=kernels,
        flops_by_op=dict(cost.flops_by_op),
    )
    rec["useful_flops_ratio"] = (
        (mf / n_chips) / terms.flops_per_device if terms.flops_per_device else None)
    if verbose:
        r = terms
        print(
            f"[{mesh_name}] {arch} × {shape.name}: OK (build {t_build:.1f}s, "
            f"run {t_run:.1f}s)\n"
            f"  params={pstats['total']/1e9:.2f}B active={n_active/1e9:.2f}B "
            f"tokens/step={tokens} useful_ratio="
            f"{rec['useful_flops_ratio'] and round(rec['useful_flops_ratio'], 3)}\n"
            f"  per-device: flops={r.flops_per_device:.3e} "
            f"bytes={r.bytes_per_device:.3e} coll={r.collective_bytes:.3e} "
            f"({comm_calls} collectives)\n"
            f"  terms(s): compute={r.t_compute:.4f} memory={r.t_memory:.4f} "
            f"collective={r.t_collective:.4f} → bottleneck={r.bottleneck}\n"
            f"  argument bytes per device: {arg_bytes}",
            flush=True,
        )
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None, help="JSONL output path")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s) for a in ARCH_NAMES for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, shape_by_name(args.shape))]
    else:
        ap.error("--arch and --shape required unless --all")
    meshes = [production_mesh_shape(mp) for mp in
              ([False, True] if args.both_meshes else [args.multi_pod])]

    out_f = None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        out_f = open(args.out, "a")
    failures = 0
    try:
        for shape_, axes in meshes:
            for arch, shp in cells:
                try:
                    rec = lower_cell(arch, shp, shape_, axes)
                except Exception:  # recorded per cell; the run goes on
                    rec = {"arch": arch, "shape": shp.name,
                           "mesh": "x".join(map(str, shape_)),
                           "status": "error", "trace": traceback.format_exc()}
                    failures += 1
                    print(f"[{rec['mesh']}] {arch} × {shp.name}: FAILED")
                    print(rec["trace"].splitlines()[-1], flush=True)
                if out_f:
                    out_f.write(json.dumps(rec) + "\n")
                    out_f.flush()
    finally:
        if out_f:
            out_f.close()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
