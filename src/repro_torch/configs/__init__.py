"""Architecture registry: one module per assigned architecture.

Each module exports:
  CONFIG  — the full published config (exercised ONLY via the dry-run)
  SMOKE   — a reduced same-family config for CPU smoke tests
  PARALLEL — {shape_name: ParallelConfig} perf knobs per workload shape
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict

from repro_torch.config import ModelConfig, ParallelConfig, ShapeConfig, SHAPES, shape_supported

ARCH_IDS = [
    "qwen2_5_3b",
    "internlm2_20b",
    "granite_8b",
    "stablelm_3b",
    "grok1_314b",
    "dbrx_132b",
    "internvl2_26b",
    "hubert_xlarge",
    "zamba2_2_7b",
    "mamba2_1_3b",
]

# CLI aliases (--arch qwen2.5-3b etc.)
ALIASES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "internlm2-20b": "internlm2_20b",
    "granite-8b": "granite_8b",
    "stablelm-3b": "stablelm_3b",
    "grok-1-314b": "grok1_314b",
    "dbrx-132b": "dbrx_132b",
    "internvl2-26b": "internvl2_26b",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
}


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    model: ModelConfig
    smoke: ModelConfig
    parallel: Dict[str, ParallelConfig]


def get_arch(name: str) -> ArchSpec:
    arch_id = ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return ArchSpec(arch_id, mod.CONFIG, mod.SMOKE, mod.PARALLEL)


def all_cells():
    """Yield every runnable (arch, shape) cell plus skip reasons."""
    for arch_id in ARCH_IDS:
        spec = get_arch(arch_id)
        for shape in SHAPES.values():
            ok, reason = shape_supported(spec.model, shape)
            yield spec, shape, ok, reason
