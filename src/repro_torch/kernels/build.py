"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``lib<name>.so`` under ``src/repro_torch/_build/<hash>/``, where the
hash covers the source, every header under ``csrc/`` and the compiler
flags, so an edited source or header builds afresh and an unchanged one is
reused.  The build directory is git-ignored
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
    "sass", "sass_opcode_counts",
]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("flash_attention", "flash_attention_bwd", "hash_mix", "sample",
           "sorted_probe", "ssd_scan", "tanimoto")
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
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
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


def count_launch(wrapper, *counters: str) -> None:
    """Add one to each of ``wrapper``'s ``counters`` (default:
    ``wrapper.launches``), all under one lock.

    The service launches kernels from many threads at once (the router's
    scatter pool, the batchers' leaders), and ``+= 1`` on an attribute is
    not atomic, so every wrapper counts through this lock.
    """
    with _COUNT_LOCK:
        for counter in counters or ("launches",):
            setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _cuobjdump() -> str:
    """``cuobjdump`` beside the ``nvcc`` that builds, else the copy that
    Triton's package carries (``triton/backends/nvidia/bin``)."""
    beside = Path(_nvcc()).parent / "cuobjdump"
    if beside.exists():
        return str(beside)
    import importlib.util

    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.origin:
        bundled = Path(spec.origin).parent / "backends" / "nvidia" / "bin" / "cuobjdump"
        if bundled.exists():
            return str(bundled)
    raise RuntimeError("cuobjdump not found beside nvcc nor in the triton package")


def sass(name: str) -> str:
    """``cuobjdump -sass`` of ``lib<name>.so``, built first if needed."""
    build([name])
    return subprocess.run([_cuobjdump(), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


def sass_opcode_counts(text: str, function: str, opcodes: Sequence[str]) -> Dict[str, int]:
    """How often each of ``opcodes`` starts an instruction in the SASS
    functions of ``text`` whose (mangled) name contains ``function``."""
    counts = {op: 0 for op in opcodes}
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = function in line
            continue
        if not inside or "*/" not in line:
            continue
        instr = line.split("*/", 1)[1].strip()
        if instr.startswith("@"):  # a predicated instruction
            instr = instr.split(None, 1)[1] if " " in instr else ""
        for op in opcodes:
            if instr.startswith(op):
                counts[op] += 1
    return counts


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
