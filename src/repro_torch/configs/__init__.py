"""Architecture registry: ``--arch <id>`` resolution (the reference's
``repro.configs``, copied as it is: the configurations are data)."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec, reduced

_MODULES: Dict[str, str] = {
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi35_moe",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "qwen3-0.6b": "repro_torch.configs.qwen3_0p6b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "mamba2-780m": "repro_torch.configs.mamba2_780m",
}


def list_archs() -> List[str]:
    return sorted(_MODULES)


def get_config(name: str) -> ArchConfig:
    try:
        mod = _MODULES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return importlib.import_module(mod).CONFIG


def applicable_shapes(cfg: ArchConfig) -> List[str]:
    """Which assignment shapes run for this arch (skips noted in DESIGN.md)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.subquadratic:
        out.append("long_500k")   # SSM / hybrid-local only
    return out


__all__ = [
    "ArchConfig",
    "ShapeSpec",
    "SHAPES",
    "reduced",
    "get_config",
    "list_archs",
    "applicable_shapes",
]
