"""family string → model builder. The port builds the ``lstm``, ``ssm`` and
``hybrid`` families; the others arrive with their slices."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, lstm, mamba2
from repro_torch.models.api import Model

_BUILDERS = {
    "ssm": mamba2.build,
    "hybrid": hybrid.build,
    "lstm": lstm.build,
}


def build(cfg: ModelConfig) -> Model:
    if cfg.family not in _BUILDERS:
        raise KeyError(f"unknown family {cfg.family!r}; the port builds "
                       f"{sorted(_BUILDERS)}")
    return _BUILDERS[cfg.family](cfg)
