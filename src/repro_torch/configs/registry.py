"""``--arch`` string → ModelConfig resolution. The port registers the
architectures it can build; the others arrive with their slices."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "gboard-cifg-lstm": "gboard_lstm",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2_7b",
}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG

