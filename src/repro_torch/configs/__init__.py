"""Assigned architecture configs (``--arch <id>``) + the paper pipeline.

Each assigned architecture has its own module with the exact published
config; ``get_config(name)`` resolves the CLI id (dashes) to the module.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from .base import ModelConfig, ShapeConfig, SHAPES, shape_by_name

_ARCH_MODULES = {
    "qwen2-72b": "qwen2_72b",
    "yi-6b": "yi_6b",
    "gemma3-12b": "gemma3_12b",
    "qwen1.5-110b": "qwen15_110b",
    "jamba-1.5-large-398b": "jamba15_large_398b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-1.3b": "mamba2_13b",
    "whisper-small": "whisper_small",
    "internvl2-76b": "internvl2_76b",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {n: get_config(n) for n in ARCH_NAMES}


# Shape-cell skip logic (DESIGN.md §Arch-applicability): long_500k needs
# sub-quadratic sequence handling; decode shapes need a decoder.
def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid") or bool(cfg.local_block)
    return True


def runnable_cells():
    """All (arch, shape) cells that run, in deterministic order."""
    out = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES:
            if cell_is_runnable(cfg, shape):
                out.append((name, shape.name))
    return out
