"""Training launcher of the port: ``python -m repro_torch.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --device cpu --steps 6 --seq-len 64 --global-batch 4 --corpus-records 400
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --full-config --seq-len 2048 --global-batch 4 --steps 5

Wires the whole stack as the reference's launcher does: a synthetic SDF
corpus → the byte-offset index (``build_index``, an in-memory
``ByteOffsetIndex``) → :class:`~repro_torch.data.pipeline.IndexedDataset`
(its fetches verified on ``--device``: ``hash_mix`` digests on the card)
→ the model from the registry (the smoke config unless ``--full-config``;
``--layers`` cuts the depth) → :class:`~repro_torch.train.trainer.Trainer`
with catalog checkpoints and heartbeats under ``--workdir``.  The flags
are the reference's, plus ``--device`` (``cuda`` by default; the CPU only
when asked for) and ``--layers``.  ``--mesh DATAxMODEL`` trains over a
DeviceMesh (``1x1``, the default, trains without one); a mesh of more
than one device runs under torchrun, one process per device, e.g.
``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh 1x2
--device cpu``: rank 0 builds the corpus, every rank the index, and the
trainer spreads each global batch over "data".  ``--arch whisper-small``
raises: the batches carry no audio frames (``Trainer``).  :func:`run` drives it
in-process and returns a summary with the history and the trainer;
:func:`build` wires the same trainer and dataset without running it.
Every fifth step prints its loss, gradient norm, ``dt`` and, in brackets,
``batch_s``: the host time of its batch (fetch, tokenize, upload), which
the card waits out; where it nears ``dt``, the loader paces the run.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..configs import ARCH_NAMES, get_config
from ..core import RecordStore, build_index
from ..core.sdfgen import CorpusSpec, generate_corpus
from ..data.pipeline import IndexedDataset
from ..device import resolve_device
from ..train.optimizer import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig, require_token_model
from .mesh import mesh_from_str

__all__ = ["build", "build_parser", "main", "run"]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="yi-6b")
    ap.add_argument("--full-config", action="store_true",
                    help="the published widths and depth (default: smoke config)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL device mesh (more than one device: run "
                         "under torchrun)")
    ap.add_argument("--device", default="cuda",
                    help="where the model trains: cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--compressor", default="int8_ef",
                    choices=["int8_ef", "int8_pc_ef", "topk_ef"],
                    help="gradient compression scheme (with --compress-grads)")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="kept fraction for --compressor topk_ef")
    ap.add_argument("--workdir", default="runs/train")
    ap.add_argument("--corpus-records", type=int, default=4000)
    ap.add_argument("--ckpt-every", type=int, default=10)
    return ap


def build(args: argparse.Namespace) -> Tuple[Trainer, IndexedDataset]:
    """The trainer ``args`` describe and the dataset it reads (the caller
    closes it): corpus, index, dataset, model config and trainer, as
    :func:`run` wires them."""
    dev = resolve_device(args.device)
    mesh = mesh_from_str(args.mesh, device=dev.type)
    cfg = get_config(args.arch)
    if not args.full_config:
        cfg = cfg.smoke()
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    require_token_model(cfg)  # before the corpus is built

    root = Path(args.workdir) / "corpus"
    spec = CorpusSpec(n_files=4, records_per_file=args.corpus_records // 4)
    if mesh is None or torch.distributed.get_rank() == 0:
        generate_corpus(root, spec)
    if mesh is not None:
        torch.distributed.barrier()   # the corpus is written before anyone reads
    store = RecordStore(root)
    ds = IndexedDataset(store, build_index(store, workers=2), args.seq_len,
                        device=dev)

    tcfg = TrainerConfig(
        seq_len=args.seq_len,
        global_batch=args.global_batch,
        steps=args.steps,
        ckpt_every=args.ckpt_every,
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads,
        compressor=args.compressor,
        topk_frac=args.topk_frac,
        opt=AdamWConfig(warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps),
    )
    return Trainer(cfg, tcfg, ds, Path(args.workdir), mesh=mesh, device=dev), ds


def run(args: argparse.Namespace, on_step=None) -> Dict[str, object]:
    """Train as ``args`` says → ``{"final_step", "history", "trainer",
    "state"}``; ``on_step(step, record)`` is called after every step."""
    tr, ds = build(args)
    try:
        final, state, hist = tr.run(on_step=on_step)
    finally:
        ds.close()
    return {"final_step": final, "history": hist, "trainer": tr, "state": state}


def main() -> None:
    args = build_parser().parse_args()

    def log(step, rec):
        if step % 5 == 0:
            print(f"step {step:5d} loss {rec['loss']:.4f} "
                  f"gnorm {rec['grad_norm']:.2f} {rec['dt']*1e3:.0f} ms "
                  f"(batch {rec['batch_s']*1e3:.0f} ms)", flush=True)

    out = run(args, on_step=log)
    tr, hist, final = out["trainer"], out["history"], out["final_step"]
    if hist:
        print(f"done: {final} steps, loss {hist[0]['loss']:.4f} → "
              f"{hist[-1]['loss']:.4f}, checkpoints at "
              f"{tr.ckpt.root} (latest {tr.ckpt.latest_step()})")
    else:  # resumed at or past --steps: nothing left to train
        print(f"done: already at step {final} (restored checkpoint), "
              f"checkpoints at {tr.ckpt.root} (latest {tr.ckpt.latest_step()})")


if __name__ == "__main__":
    main()
