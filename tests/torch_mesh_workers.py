"""Worker side of ``test_torch_mesh.py``: checks that run in every rank of a
2-process gloo group on the CPU.

:func:`spawn` starts the ranks (``spawn`` start method, a free localhost
port, torchrun's environment variables) and waits for them with a
timeout; each rank runs one group of checks and writes ``{check name:
result}`` to ``rank<r>.pt``.  A check that raises records its traceback,
so one failure does not hide the others.  This module imports torch and
the port only, never JAX, so the ranks start quickly.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import socket
import traceback
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

PROMPTS = ["InChI=1S/C4H10/c1-3-4-2", "InChI=1S/C2H6O/c1-2-3", "CCO",
           "InChI=1S/H2O/h1H2"]
SCFG = dict(max_new_tokens=6, max_len=40)
ENGINE_ARCHS = ["yi-6b", "moonshot-v1-16b-a3b", "mamba2-1.3b",
                "jamba-1.5-large-398b", "whisper-small"]
SEQ, BATCH = 32, 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def smoke_cfg(arch: str):
    """The f32 smoke config; an MoE's capacity holds every token (the
    capacity counts a dp shard's tokens, as in the reference, so with drops
    a sharded batch drops other assignments than the whole one)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max())


def engine_check(mesh, arch: str) -> Dict[str, object]:
    """Sharded vs unsharded serving of ``arch``'s smoke config: greedy
    tokens, the prefill's logits and the first decode step's."""
    from repro_torch.dist.logical import use_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.models.specs import param_specs
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = smoke_cfg(arch)
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    scfg = ServeConfig(**SCFG)
    plain = Engine(cfg, model, scfg, device="cpu")
    sharded = Engine(cfg, model, scfg, device="cpu", mesh=mesh,
                     param_specs=param_specs(model))
    want = [r.token_ids for r in plain.generate(PROMPTS)]
    got = [r.token_ids for r in sharded.generate(PROMPTS)]
    with torch.no_grad():
        batch, lens = plain.inputs(PROMPTS)
        ref, ref_cache = api.prefill(model, batch, max_len=SCFG["max_len"])
        tok = torch.argmax(ref, -1)[:, None]
        pos = torch.from_numpy(lens)
        ref_step, _ = api.decode_step(model, tok, pos, ref_cache)
        sbatch, _ = sharded.inputs(PROMPTS)
        with use_mesh(mesh):
            logits, cache = api.prefill(sharded.model, sbatch, max_len=SCFG["max_len"])
            cache = sharded._shard_cache(cache)
            step, _ = api.decode_step(sharded.model, torch.argmax(logits, -1)[:, None],
                                      sbatch["lengths"], cache)
            logits, step = logits.full_tensor(), step.full_tensor()
    placements = sorted({str(tuple(p.placements)) for p in sharded.model.parameters()})
    sampled = {}
    if arch == "yi-6b":  # every rank draws from the whole logits with one key
        hot = dataclasses.replace(scfg, greedy=False, temperature=0.8, seed=3)
        sampled = {"sampled": [r.token_ids for r in Engine(
                       cfg, model, hot, device="cpu", mesh=mesh,
                       param_specs=param_specs(model)).generate(PROMPTS)],
                   "sampled_want": [r.token_ids for r in Engine(
                       cfg, model, hot, device="cpu").generate(PROMPTS)]}
    return {"tokens": got, "want": want, "prefill_rel": _rel(logits, ref), **sampled,
            "step_rel": _rel(step, ref_step), "placements": placements,
            "original_untouched": all(type(p) is torch.nn.Parameter
                                      and not hasattr(p.data, "placements")
                                      for p in model.parameters())}


def trainer_check(mesh, arch: str, corpus: Path, work: Path, rank: int,
                  aux_coef=None):
    """3 steps of the port's Trainer on ``arch``'s smoke config (its router
    aux coefficient set to ``aux_coef`` if given), unsharded and over
    ``mesh``: the histories, the final states (whole), and the sharded
    run's checkpoint directory."""
    from repro_torch.core import RecordStore, build_index
    from repro_torch.data.pipeline import IndexedDataset
    from repro_torch.models.weights import state_to_reference
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = smoke_cfg(arch)
    if aux_coef is not None:
        cfg = dataclasses.replace(cfg, router_aux_coef=aux_coef)
    store = RecordStore(corpus)
    ds = IndexedDataset(store, build_index(store, workers=1), SEQ, device="cpu")
    tcfg = TrainerConfig(seq_len=SEQ, global_batch=BATCH, steps=3, ckpt_every=3,
                         opt=AdamWConfig(warmup_steps=2, total_steps=3))
    try:
        _, p_state, p_hist = Trainer(cfg, tcfg, ds, work / f"plain{rank}",
                                     device="cpu").run()
        tr = Trainer(cfg, tcfg, ds, work / "sharded", mesh=mesh, device="cpu")
        _, s_state, s_hist = tr.run()
        sharded_named = {n: t.clone() for n, t in state_to_reference(s_state).items()}
        kinds = sorted({type(p).__name__ for p in s_state["model"].parameters()})
    finally:
        ds.close()
    return {"plain": p_hist, "sharded": s_hist, "kinds": kinds,
            "plain_state": {n: t.clone() for n, t in state_to_reference(p_state).items()},
            "sharded_state": sharded_named, "ckpt": str(tr.ckpt.root)}


def guard_checks(mesh) -> Dict[str, object]:
    """A DTensor that reaches a kernel's ops raises; constrain raises on a
    plain tensor under a mesh and lays a DTensor out as the rules say; a
    plain tensor that meets a DTensor under a mesh raises unless
    ``replicate`` made it a DTensor."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.dist.logical import constrain, replicate, use_mesh
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    out = {}
    q = distribute_tensor(torch.randn(2, 2, 4, 8), mesh, [Replicate(), Replicate()])
    for name, call in (("flash_attention", lambda: flash_attention(q, q, q)),
                       ("ssd_scan", lambda: ssd_scan(torch.randn(2, 3, 4, 5).clamp(0),
                                                     q[:, 0, :3, 0]))):
        try:
            call()
            out[name] = "no error"
        except TypeError as e:
            out[name] = str(e)
    with use_mesh(mesh):
        try:
            constrain(torch.zeros(4, 6), "batch", "d_ff")
            out["plain"] = "no error"
        except TypeError as e:
            out["plain"] = str(e)
        x = distribute_tensor(torch.arange(24.0).reshape(4, 6), mesh,
                              [Replicate(), Replicate()])
        y = constrain(x, "batch", "d_ff")
        out["placements"] = [str(p) for p in y.placements]
        out["values_kept"] = bool(torch.equal(y.full_tensor(), x.full_tensor()))
        want = [Shard(0) if mesh.shape[0] > 1 else Replicate(),
                Shard(1) if mesh.shape[1] > 1 else Replicate()]
        out["want"] = [str(p) for p in want]
        try:
            torch.ones(4, 6) + x
            out["mixed"] = "no error"
        except RuntimeError as e:
            out["mixed"] = str(e)
        out["replicated_sum"] = bool(torch.equal(
            (replicate(torch.ones(4, 6)) + x).full_tensor(), x.full_tensor() + 1))
    return out


def backward_thread_check(mesh) -> Dict[str, object]:
    """The loss's backward run on a thread of its own, where the caller's
    ``use_mesh`` is not active (autograd runs a CUDA backward so, while the
    caller waits): the blocks ``remat`` recomputes still run under the
    forward's mesh (a DTensor would reach ``ssd_scan`` otherwise), and the
    gradients equal those of the caller's thread."""
    import threading

    from repro_torch.dist.logical import use_mesh
    from repro_torch.launch.sharding import (batch_shardings, distribute,
                                             distribute_params, module_copy)
    from repro_torch.models.registry import build_model
    from repro_torch.models.specs import param_specs

    cfg = smoke_cfg("mamba2-1.3b")
    api = build_model(cfg)
    model = api.init(torch.Generator().manual_seed(0), device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    model = distribute_params(module_copy(model), mesh, param_specs(model))
    tokens = torch.randint(3, 200, (4, 16), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": distribute(tokens, mesh, batch_shardings(mesh, {"t": tokens})["t"])}
    params = list(model.parameters())
    grads = {}

    def other():
        # the port's own mesh context (a Python thread-local) is not active
        # on a worker thread
        try:
            grads["other"] = torch.autograd.grad(loss, params)
        except Exception:  # reported by the caller
            grads["error"] = traceback.format_exc()

    with use_mesh(mesh):
        loss, _ = api.loss(model, batch)
        here = torch.autograd.grad(loss, params, retain_graph=True)
        # the caller waits inside its use_mesh, as it waits for a CUDA backward
        t = threading.Thread(target=other)
        t.start()
        t.join(60)
    if "error" in grads:
        raise RuntimeError(grads["error"])
    return {"alive": t.is_alive(), "equal": "other" in grads and all(
        torch.equal(a.full_tensor(), b.full_tensor())
        for a, b in zip(here, grads["other"]))}


def moe_override_check(mesh) -> Dict[str, object]:
    """``axis_rules({"experts": None})`` turns the expert-parallel path
    off; both paths give the same outputs (no drops)."""
    from repro_torch.dist.logical import axis_rules, use_mesh
    from repro_torch.launch.sharding import distribute_params, module_copy
    from repro_torch.models.moe import moe_apply, moe_init, monitor
    from repro_torch.models.specs import param_specs

    cfg = smoke_cfg("qwen3-moe-235b-a22b")
    m = moe_init(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1))
    want, aux_want = moe_apply(m, cfg, x)
    md = distribute_params(module_copy(m), mesh, param_specs(m))
    from repro_torch.launch.sharding import batch_shardings, distribute

    xd = distribute(x, mesh, batch_shardings(mesh, {"x": x})["x"])
    with torch.no_grad(), use_mesh(mesh):
        with monitor(md) as calls:
            y_ep, aux_ep = moe_apply(md, cfg, xd)
        with axis_rules({"experts": None}):
            y_local, aux_local = moe_apply(md, cfg, xd)
        dropped = int(sum(c.dropped.full_tensor() for c in calls))
        top_i = calls[0].top_i.full_tensor()
    with monitor(m) as ref_calls:
        moe_apply(m, cfg, x)
    n_dp = mesh.shape[0]
    shards = [moe_apply(m, cfg, part)[1] for part in x.chunk(n_dp)]
    return {"ep_rel": _rel(y_ep.full_tensor(), want),
            "local_rel": _rel(y_local.full_tensor(), want),
            "aux": [float(aux_ep.full_tensor()), float(aux_local.full_tensor()),
                    float(aux_want), float(sum(shards) / n_dp)],
            "dropped": dropped, "top_i_equal": bool(torch.equal(top_i, ref_calls[0].top_i))}


def launcher_check(kind: str, mesh_str: str, work: Path) -> Dict[str, object]:
    if kind == "train":
        from repro_torch.launch import train

        args = train.build_parser().parse_args([
            "--arch", "yi-6b", "--device", "cpu", "--mesh", mesh_str, "--steps", "2",
            "--seq-len", "32", "--global-batch", "4", "--corpus-records", "200",
            "--ckpt-every", "2", "--workdir", str(work / "launch_train")])
        out = train.run(args)
        out["state"]["model"]  # the run reached its end
        return {"final_step": out["final_step"],
                "losses": [h["loss"] for h in out["history"]],
                "latest": out["trainer"].ckpt.latest_step()}
    from repro_torch.launch import serve

    args = serve.build_parser().parse_args([
        "--arch", "yi-6b", "--device", "cpu", "--mesh", mesh_str,
        "--max-new-tokens", "4", "--prompts", *PROMPTS])
    out = serve.run(args)
    plain = serve.run(serve.build_parser().parse_args([
        "--arch", "yi-6b", "--device", "cpu", "--max-new-tokens", "4",
        "--prompts", *PROMPTS]))
    refused = ""
    try:
        serve.run(serve.build_parser().parse_args([
            "--arch", "yi-6b", "--device", "cpu", "--mesh", mesh_str, "--continuous"]))
    except SystemExit as e:
        refused = str(e)
    return {"mesh": out["mesh"], "tokens": out["runs"][0]["token_ids"],
            "want": plain["runs"][0]["token_ids"], "refused": refused}


def _run_checks(rank: int, shape, tmp: str, checks) -> Dict[str, object]:
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    results = {}
    for name, fn in checks(mesh, Path(tmp), rank):
        try:
            results[name] = {"ok": True, **fn()}
        except Exception:  # recorded: the parent's test for it fails with it
            results[name] = {"ok": False, "error": traceback.format_exc()}
    return results


def group_1x2(mesh, tmp: Path, rank: int):
    """Tensor parallel: heads, d_ff, vocab, experts over "model"."""
    for arch in ENGINE_ARCHS:
        yield f"engine/{arch}", (lambda a=arch: engine_check(mesh, a))
    yield "trainer/yi-6b", lambda: trainer_check(mesh, "yi-6b", tmp / "corpus",
                                                 tmp / "yi", rank)
    yield "trainer/moonshot-v1-16b-a3b", lambda: trainer_check(
        mesh, "moonshot-v1-16b-a3b", tmp / "corpus", tmp / "moonshot", rank)
    yield "guards", lambda: guard_checks(mesh)
    yield "moe_override", lambda: moe_override_check(mesh)
    yield "backward_thread", lambda: backward_thread_check(mesh)
    yield "launch/train", lambda: launcher_check("train", "1x2", tmp)


def group_2x1(mesh, tmp: Path, rank: int):
    """Data parallel: the batch over "data", parameters' d_model (FSDP)."""
    for arch in ENGINE_ARCHS:
        yield f"engine/{arch}", (lambda a=arch: engine_check(mesh, a))
    yield "trainer/mamba2-1.3b", lambda: trainer_check(
        mesh, "mamba2-1.3b", tmp / "corpus", tmp / "mamba", rank)
    # over "data" the router's aux loss is the mean of each dp shard's own
    # (the reference's pmean), not the whole batch's: a different loss, so
    # the aux term is left out of this comparison (the (1, 2) group keeps it)
    yield "trainer/moonshot-v1-16b-a3b", lambda: trainer_check(
        mesh, "moonshot-v1-16b-a3b", tmp / "corpus", tmp / "moonshot", rank,
        aux_coef=0.0)
    yield "guards", lambda: guard_checks(mesh)
    yield "moe_override", lambda: moe_override_check(mesh)
    yield "backward_thread", lambda: backward_thread_check(mesh)
    yield "launch/serve", lambda: launcher_check("serve", "2x1", tmp)


GROUPS: Dict[str, Callable] = {"1x2": group_1x2, "2x1": group_2x1}


def _entry(rank: int, world: int, port: int, group: str, tmp: str) -> None:
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    shape = tuple(int(n) for n in group.split("x"))
    results = _run_checks(rank, shape, tmp, GROUPS[group])
    torch.save(results, Path(tmp) / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


def spawn(group: str, tmp: Path):
    """Start ``group``'s checks in 2 ranks → their processes;
    :func:`collect` waits for them."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_entry, args=(r, 2, port, group, str(tmp)))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs


def collect(procs, tmp: Path, timeout: float) -> Dict[str, object]:
    """Wait up to ``timeout`` seconds in all for the ranks; kill the rest
    and raise if they did not end, or ended in error; → rank 0's results
    (every rank runs the same checks on the same data)."""
    import time

    end = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    if alive:
        raise TimeoutError(f"mesh ranks still running after {timeout} s")
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise RuntimeError(f"mesh ranks exited with {codes}")
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return results[0]


def as_numpy(named: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {n: t.float().numpy() for n, t in named.items()}
