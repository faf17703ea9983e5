"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``
return the :class:`~repro_torch.models.config.ModelConfig` of each of the
ten architectures, copied from the JAX package's ``configs``.

The JAX package's ``input_specs`` and ``batch_specs`` build stand-ins
for its dry run; their counterparts come with the port's dry-run tools
(ROADMAP A13.6).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig
from .shapes import SHAPES, Shape, applicable, cell_matrix  # noqa: F401

_MODULES = {
    "glm4-9b": "glm4_9b",
    "qwen2.5-32b": "qwen25_32b",
    "gemma2-27b": "gemma2_27b",
    "yi-9b": "yi_9b",
    "zamba2-1.2b": "zamba2_1p2b",
    "hubert-xlarge": "hubert_xlarge",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "rwkv6-7b": "rwkv6_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "olmoe-1b-7b": "olmoe_1b_7b",
}

ARCHS = tuple(_MODULES)


def _mod(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    return importlib.import_module(f".{_MODULES[arch]}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _mod(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _mod(arch).smoke()
