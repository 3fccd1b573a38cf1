"""A tiny copy of the benchmark for CPU tests: the harness's files as they
are, with configurations and mixes cut to a size the CPU serves in
seconds, under a root of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent

DENSE = {
    "name": "yi-6b", "source": "test", "arch": "yi-6b", "family": "dense",
    "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
    "vocab_size": 512, "max_position_embeddings": 256, "rope_theta": 5000000.0,
    "rms_norm_eps": 1e-05, "tie_word_embeddings": False, "torch_dtype": "bfloat16",
    "tokenizer": {"bos": 256, "eos": 257, "pad": 258}, "reduced": [],
}
SSM = {
    "name": "mamba2-1.3b", "source": "test", "arch": "mamba2-1.3b", "family": "ssm",
    "d_model": 64, "n_layer": 2, "vocab_size": 512, "d_state": 16, "d_conv": 4,
    "expand": 2, "headdim": 16, "ngroups": 1, "chunk_size": 32, "norm_eps": 1e-05,
    "tie_embeddings": True, "torch_dtype": "bfloat16",
    "tokenizer": {"bos": 256, "eos": 257, "pad": 258}, "reduced": [],
}
CHAT = {
    "driver": "continuous", "clients": 4, "block_size": 16, "max_len": 128,
    "prefix_cache": True, "strata": 4,
    "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.8, "min": 8, "max": 100},
    "output": {"dist": "uniform", "min": 4, "max": 12},
    "sampling": {"temperature": 0.8, "top_k": 40}, "trace_seconds": 1,
    "check": {"requests": 3},
}
TRAIN = {
    "driver": "train", "records": 64, "files": 2, "batch": 4, "seq_len": 512,
    "opt": {"lr": 0.003, "b1": 0.9, "b2": 0.95, "eps": 1e-08, "weight_decay": 0.1,
            "grad_clip": 1.0, "warmup_steps": 2, "total_steps": 100, "min_lr_frac": 0.1},
    "checked_steps": 3, "remat": "names", "trace_seconds": 1,
}
DOCS = {
    "driver": "static", "batch": 4, "strata": 4, "new_tokens": 12, "max_len": 112,
    "prompt": {"dist": "uniform", "min": 40, "max": 100},
    "output": {"dist": "fixed", "value": 12}, "sampling": None, "trace_seconds": 1,
    "check": {"requests": 4},
}


def make(root: Path, dtype: str = "bfloat16") -> Path:
    """The tiny benchmark under ``root``: ``root/BENCHMARK.json`` (the
    repository's, its files pointed at the tiny configurations) and
    ``root/bench``; ``root/src`` links the repository's program."""
    root = Path(root)
    shutil.copytree(BENCH, root / "bench", ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        body = dict(DENSE if c["name"] == "yi-6b" else SSM, torch_dtype=dtype)
        (root / c["file"]).write_text(json.dumps(body))
    (root / "bench" / "mixes" / "chat.json").write_text(json.dumps(CHAT))
    (root / "bench" / "mixes" / "docs.json").write_text(json.dumps(DOCS))
    (root / "bench" / "mixes" / "train.json").write_text(json.dumps(TRAIN))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
