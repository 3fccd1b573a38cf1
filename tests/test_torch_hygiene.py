"""Import hygiene of the port: ``repro_torch`` stands alone.

The port imports torch and numpy, never JAX, Triton or anything of the
reference package ``repro`` (``repro_torch`` itself is a different name).
Checked two ways: a fresh interpreter imports every module of the port and
then finds none of those names in ``sys.modules``, and a scan of the
port's sources and ``chip_smoke.py`` finds no such import statement.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(
    n for n in sys.modules
    if n in ("jax", "jaxlib", "triton", "repro")
    or n.startswith(("jax.", "jaxlib.", "triton.", "repro."))
)
print(json.dumps({"imported": names, "forbidden": bad}))
"""

_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|triton|repro)(?:\.|\s|,|$)", re.M
)


def test_importing_every_port_module_pulls_in_no_jax_triton_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=str(ROOT), timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    for mod in ("repro_torch.core.store", "repro_torch.core.verify",
                "repro_torch.kernels.build", "repro_torch.launch.funnel",
                "repro_torch.kernels.sorted_probe.kernel",
                "repro_torch.kernels.hash_mix.kernel",
                "repro_torch.kernels.tanimoto.kernel",
                "repro_torch.kernels.tanimoto.ops",
                "repro_torch.launch.serve_index",
                "repro_torch.runtime.fault",
                "repro_torch.service.api", "repro_torch.service.health",
                "repro_torch.service.loadgen", "repro_torch.service.router",
                "repro_torch.service.scheduler",
                "repro_torch.service.transport",
                "repro_torch.configs", "repro_torch.configs.base",
                "repro_torch.configs.yi_6b", "repro_torch.configs.gemma3_12b",
                "repro_torch.data.tokenizer", "repro_torch.checkpoint.manager",
                "repro_torch.models.common", "repro_torch.models.transformer",
                "repro_torch.models.weights", "repro_torch.models.registry",
                "repro_torch.kernels.flash_attention.kernel",
                "repro_torch.kernels.flash_attention.ref",
                "repro_torch.kernels.flash_attention.ops",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.kernels.ssd_scan.kernel",
                "repro_torch.kernels.ssd_scan.ref",
                "repro_torch.kernels.ssd_scan.ops",
                "repro_torch.models.mamba2", "repro_torch.models.ssm",
                "repro_torch.models.moe", "repro_torch.models.hybrid",
                "repro_torch.configs.mamba2_13b",
                "repro_torch.configs.jamba15_large_398b"):
        assert mod in report["imported"]


def test_no_forbidden_import_statements_in_port_sources():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = [
        f"{p.relative_to(ROOT)}: {m.group(0).strip()}"
        for p in sources
        for m in _IMPORT.finditer(p.read_text())
    ]
    assert offenders == []


def test_the_import_pattern_tells_repro_from_repro_torch():
    assert _IMPORT.search("from repro.core import x")
    assert _IMPORT.search("import repro\n")
    assert _IMPORT.search("    import jax.numpy as jnp")
    assert _IMPORT.search("import triton")
    assert not _IMPORT.search("from repro_torch.core import x")
    assert not _IMPORT.search("import repro_torch")
    assert not _IMPORT.search('salt = "repro-corpus-v1"')
