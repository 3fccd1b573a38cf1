"""Catalog checkpoints in the reference package's on-disk layout.

One checkpoint is a directory::

    <dir>/
        shard_00000.bin     # every tensor's raw bytes, concatenated
        catalog.csv         # name, byte_offset, nbytes, dtype, shape, digest
        meta.json

the layout that ``repro.checkpoint.manager.save_pytree`` writes, so that a
checkpoint of either package opens in the other (the weight bridge: the
reference draws its parameters from ``jax.random``, which torch cannot
reproduce, so parity runs carry one set of weights across).  Names are
the ``/``-joined paths of a nested dict (``blocks/attn/wq``,
``embed/table``), with the keys of each dict in sorted order, as JAX
flattens a dict; ``dtype`` is numpy's name (``float32``, ``bfloat16``,
...); ``digest`` is the blake2b-128 of the tensor's bytes, checked on every
restore (a corrupt shard or a stale catalog raises).  A ``bfloat16`` entry
is read as uint16 and viewed as ``torch.bfloat16``, so no ``ml_dtypes`` is
needed.  The publish is atomic (temporary directory, then ``os.replace``).

Restored tensors land on ``device``, the card by default like every entry
point of the port (``device="cpu"`` for the host).  The reference's asynchronous ``CheckpointManager`` (retention, resume) belongs
to training and is not ported yet.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = [
    "CatalogEntry",
    "flatten_with_names",
    "load_catalog",
    "read_tensor",
    "restore_named",
    "restore_pytree",
    "save_pytree",
]

_CATALOG_HEADER = ["name", "byte_offset", "nbytes", "dtype", "shape", "digest"]
Leaf = Union[torch.Tensor, np.ndarray]


@dataclass(frozen=True)
class CatalogEntry:
    name: str
    byte_offset: int
    nbytes: int
    dtype: str
    shape: Tuple[int, ...]
    digest: str


def _digest(buf: bytes) -> str:
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


def flatten_with_names(tree: Any, prefix: str = "") -> List[Tuple[str, Leaf]]:
    """``(name, leaf)`` of a nested dict / list, in the order JAX flattens
    it: dict keys sorted, list items in order, names joined with ``/``."""
    if isinstance(tree, Mapping):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Leaf]] = []
    for key, sub in items:
        out.extend(flatten_with_names(sub, f"{prefix}/{key}" if prefix else key))
    return out


def _to_bytes(leaf: Leaf) -> Tuple[bytes, str, Tuple[int, ...]]:
    """Raw little-endian bytes, numpy dtype name and shape of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().tobytes(), "bfloat16", tuple(t.shape)
        leaf = t.numpy()
    arr = np.ascontiguousarray(leaf)
    return arr.tobytes(), str(arr.dtype), tuple(arr.shape)


def _from_bytes(buf: bytes, entry: CatalogEntry) -> torch.Tensor:
    if entry.dtype == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).reshape(entry.shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(buf, dtype=np.dtype(entry.dtype)).reshape(entry.shape)
    return torch.from_numpy(arr.copy())


def save_pytree(tree: Any, directory: Union[str, Path],
                meta: Optional[dict] = None) -> Path:
    """Write one catalog checkpoint of a nested dict of tensors or arrays
    (atomic); a flat ``{name: tensor}`` dict writes its names as they are."""
    directory = Path(directory)
    tmp = directory.with_name(directory.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    entries: List[CatalogEntry] = []
    offset = 0
    with open(tmp / "shard_00000.bin", "wb") as f:
        for name, leaf in flatten_with_names(tree):
            buf, dtype, shape = _to_bytes(leaf)
            f.write(buf)
            entries.append(CatalogEntry(name, offset, len(buf), dtype, shape,
                                        _digest(buf)))
            offset += len(buf)
    with open(tmp / "catalog.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(_CATALOG_HEADER)
        for e in entries:
            w.writerow([e.name, e.byte_offset, e.nbytes, e.dtype,
                        json.dumps(list(e.shape)), e.digest])
    (tmp / "meta.json").write_text(json.dumps(meta or {}, indent=1))
    if directory.exists():
        shutil.rmtree(directory)
    os.replace(tmp, directory)
    return directory


def load_catalog(directory: Union[str, Path]) -> Dict[str, CatalogEntry]:
    out: Dict[str, CatalogEntry] = {}
    with open(Path(directory) / "catalog.csv", newline="") as f:
        r = csv.reader(f)
        header = next(r)
        if header != _CATALOG_HEADER:
            raise ValueError(f"bad catalog header {header}")
        for name, off, nb, dt, shp, dg in r:
            out[name] = CatalogEntry(name, int(off), int(nb), dt,
                                     tuple(json.loads(shp)), dg)
    return out


def read_tensor(directory: Union[str, Path], entry: CatalogEntry,
                verify: bool = True) -> torch.Tensor:
    """One tensor by its catalog offset (a seek and one read)."""
    with open(Path(directory) / "shard_00000.bin", "rb") as f:
        f.seek(entry.byte_offset)
        buf = f.read(entry.nbytes)
    if verify and _digest(buf) != entry.digest:
        raise IOError(
            f"checkpoint integrity failure for {entry.name!r} "
            f"(digest mismatch: corrupted shard or stale catalog)"
        )
    return _from_bytes(buf, entry)


def restore_named(directory: Union[str, Path], names=None, verify: bool = True,
                  device: DeviceLike = "cuda") -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` for ``names`` (all entries when None), read in
    byte-offset order, each digest checked, placed on ``device``."""
    dev = resolve_device(device)
    catalog = load_catalog(directory)
    names = list(catalog) if names is None else list(names)
    missing = [n for n in names if n not in catalog]
    if missing:
        raise KeyError(f"checkpoint missing tensors: {missing[:5]}")
    loaded: Dict[str, torch.Tensor] = {}
    with open(Path(directory) / "shard_00000.bin", "rb") as f:
        for n in sorted(names, key=lambda n: catalog[n].byte_offset):
            e = catalog[n]
            f.seek(e.byte_offset)
            buf = f.read(e.nbytes)
            if verify and _digest(buf) != e.digest:
                raise IOError(f"integrity failure for {n!r}")
            loaded[n] = _from_bytes(buf, e).to(dev)
    return {n: loaded[n] for n in names}


def restore_pytree(tree_like: Any, directory: Union[str, Path],
                   verify: bool = True, device: DeviceLike = "cuda") -> Any:
    """Restore into the nested-dict structure of ``tree_like`` (names must
    match the catalog's)."""
    named = restore_named(
        directory, [n for n, _ in flatten_with_names(tree_like)], verify, device
    )

    def rebuild(tree, prefix):
        if isinstance(tree, Mapping):
            return {k: rebuild(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(x, f"{prefix}/{i}" if prefix else str(i))
                              for i, x in enumerate(tree))
        return named[prefix]

    return rebuild(tree_like, "")
