"""Architecture registry: the ten configurations and the cell grid.

Port of ``repro/configs/registry.py`` over the port's own configuration
modules (``configs/__init__.py::_MODULES``), in the reference's order.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shape_applicable

# the reference's order of the ten architectures
_ORDER = ("jamba-v0.1-52b", "olmoe-1b-7b", "deepseek-moe-16b", "gemma3-4b", "qwen3-8b",
          "command-r-35b", "mistral-large-123b", "mamba2-2.7b", "whisper-small",
          "internvl2-1b")

_REGISTRY: dict | None = None


def _load() -> dict:
    from repro_torch.configs import _MODULES
    assert set(_ORDER) == set(_MODULES), (_ORDER, tuple(_MODULES))
    return {name: importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
            for name in _ORDER}


def _registry() -> dict:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    return _REGISTRY


def all_archs() -> tuple[str, ...]:
    return tuple(_registry().keys())


def get_config(name: str) -> ModelConfig:
    reg = _registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(reg)}")
    return reg[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells(include_skipped: bool = False):
    """Yield (arch_name, shape_name, applicable) for the 40 cells."""
    for arch in all_archs():
        for shape in SHAPES:
            ok = shape_applicable(arch, shape)
            if ok or include_skipped:
                yield arch, shape, ok
