"""family string → model builder: every family of the reference."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import (encdec, hybrid, lstm, mamba2, moe,
                                transformer, vlm)
from repro_torch.models.api import Model

_BUILDERS = {
    "dense": transformer.build,
    "moe": moe.build,
    "ssm": mamba2.build,
    "hybrid": hybrid.build,
    "encdec": encdec.build,
    "vlm": vlm.build,
    "lstm": lstm.build,
}


def build(cfg: ModelConfig) -> Model:
    if cfg.family not in _BUILDERS:
        raise KeyError(f"unknown family {cfg.family!r}")
    return _BUILDERS[cfg.family](cfg)
