"""Every public name of the reference is in the port, or is left out by
design for a stated reason.

For each ``src/repro/**/*.py`` the port must have the file of the same
path under ``src/repro_torch/``, and every public top-level name of the
reference's file (functions, classes, names assigned; in an
``__init__.py`` also the names it imports) must be a top-level name of the
port's, unless ``BY_DESIGN`` lists it with a one-line reason.  Every entry
of ``BY_DESIGN`` must still be missing, so the list cannot go stale.  The
files are parsed; neither package is imported.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent / "src"
REF, PORT = ROOT / "repro", ROOT / "repro_torch"

_PYTREE = ("a type alias of JAX pytrees (Any); the port's trees are dicts, "
           "lists and nn.Modules")
_PALLAS = "the Pallas kernel; ported by hand as CUDA C++ in csrc/"
_TILING = "a tiling constant of the Pallas kernel; the CUDA source has its own"
_HLO = ("reads XLA's compiled HLO or cost analysis; the port's dry-run counts on "
        "meta tensors")
_UNROLL = ("unrolls lax.scan for XLA's cost analysis; the port loops in Python "
           "and its dry-run counts on meta tensors")
_XLA_ATTN = ("the XLA attention's implementation switch; the port's attention is "
             "the CUDA kernel or its plain version")

BY_DESIGN = {
    ("checkpoint/manager.py", "PyTree"): _PYTREE,
    ("dist/compress.py", "PyTree"): _PYTREE,
    ("launch/sharding.py", "PyTree"): _PYTREE,
    ("models/common.py", "PyTree"): _PYTREE,
    ("models/hybrid.py", "PyTree"): _PYTREE,
    ("models/registry.py", "PyTree"): _PYTREE,
    ("models/transformer.py", "PyTree"): _PYTREE,
    ("train/loop.py", "PyTree"): _PYTREE,
    ("train/optimizer.py", "PyTree"): _PYTREE,
    ("flags.py", "ATTN_IMPL"): _XLA_ATTN,
    ("flags.py", "ATTN_CHUNK"): _XLA_ATTN,
    ("flags.py", "scan_unroll"): _UNROLL,
    ("flags.py", "unroll_scans"): _UNROLL,
    ("flags.py", "unrolling"): _UNROLL,
    ("kernels/flash_attention/ref.py", "flash_attention_chunked"): _XLA_ATTN,
    ("kernels/flash_attention/kernel.py", "flash_attention_pallas"): _PALLAS,
    ("kernels/flash_attention/kernel.py", "NEG_INF"): _TILING,
    ("kernels/hash_mix/kernel.py", "hash_mix_pallas"): _PALLAS,
    ("kernels/hash_mix/kernel.py", "DEFAULT_BLOCK_ROWS"): _TILING,
    ("kernels/sorted_probe/kernel.py", "probe_blocks_pallas"): _PALLAS,
    ("kernels/sorted_probe/kernel.py", "DEFAULT_TABLE_BLOCK"): _TILING,
    ("kernels/sorted_probe/kernel.py", "SENTINEL"): _TILING,
    ("kernels/sorted_probe/ops.py", "sorted_probe_pallas"): _PALLAS,
    ("kernels/sorted_probe/ref.py", "pair_eq"):
        "a uint32-pair compare of the Pallas oracle; the port compares 64-bit keys",
    ("kernels/sorted_probe/ref.py", "pair_less"):
        "a uint32-pair compare of the Pallas oracle; the port compares 64-bit keys",
    ("kernels/sorted_probe/ref.py", "sort_pairs"):
        "a uint32-pair sort of the Pallas oracle; the port sorts 64-bit keys",
    ("kernels/ssd_scan/kernel.py", "ssd_scan_pallas"): _PALLAS,
    ("kernels/tanimoto/kernel.py", "tanimoto_blocks_pallas"): _PALLAS,
    ("kernels/tanimoto/kernel.py", "DEFAULT_DB_BLOCK"): _TILING,
    ("kernels/tanimoto/kernel.py", "PAD_IDX_SENTINEL"): _TILING,
    ("kernels/tanimoto/ops.py", "tanimoto_topk_pallas"): _PALLAS,
    ("launch/dryrun.py", "abstract_init"):
        "jax.eval_shape of the init; the port builds the model on meta tensors",
    ("launch/dryrun.py", "abstract_cache"):
        "jax.eval_shape of the cache; the port builds the cache on meta tensors",
    ("launch/dryrun.py", "build_lowered"): _HLO,
    ("launch/dryrun.py", "probe_roofline"): _HLO,
    ("launch/roofline.py", "collective_bytes_from_hlo"): _HLO,
    ("launch/roofline.py", "roofline_from_compiled"): _HLO,
}


def _public_names(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) else [t]
                out.update(e.id for e in elts if isinstance(e, ast.Name))
        elif path.name == "__init__.py" and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _gaps():
    missing_files, missing = [], set()
    for ref in sorted(REF.rglob("*.py")):
        rel = ref.relative_to(REF).as_posix()
        port = PORT / rel
        if not port.exists():
            missing_files.append(rel)
            continue
        missing |= {(rel, n) for n in _public_names(ref) - _public_names(port)}
    return missing_files, missing


def test_every_reference_file_has_a_counterpart():
    assert _gaps()[0] == []


def test_every_missing_name_is_left_out_by_design():
    _, missing = _gaps()
    assert sorted(missing - BY_DESIGN.keys()) == []
    assert sorted(BY_DESIGN.keys() - missing) == [], "stale BY_DESIGN entries"


@pytest.mark.parametrize("key", sorted(BY_DESIGN))
def test_by_design_entry_has_a_one_line_reason(key):
    reason = BY_DESIGN[key]
    assert reason.strip() and "\n" not in reason


@pytest.mark.parametrize("rel,name", [
    ("flags.py", "REMAT_POLICY"), ("flags.py", "remat_policy"),
    ("flags.py", "DECODE_CHUNKED"),
    ("models/common.py", "decode_attention_chunked"),
    ("kernels/tanimoto/ops.py", "tanimoto_topk_host"),
    ("kernels/tanimoto/ref.py", "tanimoto_topk_naive"),
    ("train/loop.py", "make_serve_step"),
])
def test_names_of_the_last_slice_are_in_the_port(rel, name):
    assert name in _public_names(REF / rel)
    assert name in _public_names(PORT / rel)
