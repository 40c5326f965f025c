from repro_torch.configs.base import ClientConfig, DPConfig, ModelConfig
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                          all_configs, get_config)

__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "ClientConfig", "DPConfig",
           "ModelConfig", "all_configs", "get_config"]
