"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``lib<name>.so`` under ``src/repro_torch/_build/<hash>/``, where the
hash covers the source and the compiler flags, so an edited source builds
afresh and an unchanged one is reused.  The build directory is git-ignored
and filled at first use: the first wrapper call, or :func:`build` (which
``chip_smoke.py`` calls to build every source at once, one ``nvcc`` per
source, all started together).

Nothing here runs at import time: the CPU tests import every module of the
port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

__all__ = [
    "SOURCES", "NVCC_FLAGS", "build", "count_launch", "load", "ptxas_report",
]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("flash_attention", "hash_mix", "sorted_probe", "ssd_scan", "tanimoto")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, CUDA_PATH, /usr/local/cuda): the "
        "port's CUDA kernels are built from src/repro_torch/csrc at first use"
    )


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names: Sequence[str] = SOURCES) -> float:
    """Compile every library in ``names`` that is not built yet.

    One ``nvcc`` per source, all started together.  Raises with the
    compiler's output if any of them fails (the others are stopped).
    Returns the wall seconds spent.
    """
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    procs = []
    try:
        for name, out in todo:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            procs.append((name, out, tmp, p))
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            text = log.decode(errors="replace")
            if p.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu (exit {p.returncode}):\n{text}"
                )
            (out.parent / f"{name}.ptxas.txt").write_text(text)
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    finally:
        for _, _, tmp, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            if tmp.exists():
                tmp.unlink()
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines of the last build of ``name`` (registers,
    shared memory, spills), or "" when it was not built here."""
    p = _lib_path(name).parent / f"{name}.ptxas.txt"
    return p.read_text() if p.exists() else ""


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``.

    The service launches kernels from many threads at once (the router's
    scatter pool, the batchers' leaders), and ``+= 1`` on an attribute is
    not atomic, so every wrapper counts through this lock.
    """
    with _COUNT_LOCK:
        wrapper.launches += 1


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib
