# Counterpart of src/repro/configs/__init__.py; nothing left unported.  The
# port lists architectures of its own beside the reference's (`PORT_ONLY`);
# `reference_archs` is the list both packages have.
"""Architecture registry: ``get_config("qwen3-1.7b")`` etc."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ArchConfig, AttnConfig, MLAConfig, MoEConfig, SSMConfig, ShapeConfig,
    SHAPES,
    shapes_for, reduced, dtype_of,
)

_MODULES = {
    "mamba2-780m": "mamba2_780m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "gemma3-4b": "gemma3_4b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-1.7b": "qwen3_1_7b",
    "mistral-large-123b": "mistral_large_123b",
    "whisper-tiny": "whisper_tiny",
    "zamba2-1.2b": "zamba2_1_2b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-v2-lite": "deepseek_v2_lite",
}

# Architectures of the port alone, with why the JAX package has none.
PORT_ONLY = {
    "deepseek-v2-lite": "latent attention (MLA), shared experts at their own "
                        "width and a leading dense layer are the port's",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def reference_archs() -> List[str]:
    """The architectures that the JAX package lists too."""
    return [a for a in _MODULES if a not in PORT_ONLY]


def get_config(name: str) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
