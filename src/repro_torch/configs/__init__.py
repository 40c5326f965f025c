from repro_torch.configs.base import (MULTI_POD, SINGLE_POD, ClientConfig,
                                      DPConfig, MeshConfig, ModelConfig)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                          all_configs, get_config)

__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "ClientConfig", "DPConfig",
           "MULTI_POD", "MeshConfig", "ModelConfig", "SINGLE_POD",
           "all_configs", "get_config"]
