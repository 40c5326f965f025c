"""``--arch`` string → ModelConfig resolution: every architecture of the
reference's registry, in its order."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "mamba2-370m": "mamba2_370m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "granite-3-2b": "granite_3_2b",
    "chameleon-34b": "chameleon_34b",
    "stablelm-12b": "stablelm_12b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-small": "whisper_small",
    "phi3-medium-14b": "phi3_medium_14b",
    "gboard-cifg-lstm": "gboard_lstm",
}

ASSIGNED_ARCHS = [k for k in _ARCH_MODULES if k != "gboard-cifg-lstm"]
ALL_ARCHS = list(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ALL_ARCHS}
