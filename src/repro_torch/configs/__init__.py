from repro_torch.configs.base import (DECODE_32K, INPUT_SHAPES, LONG_500K,
                                      MULTI_POD, PREFILL_32K, SINGLE_POD,
                                      TRAIN_4K, ClientConfig, DPConfig,
                                      InputShape, MeshConfig, ModelConfig)
from repro_torch.configs.registry import (ALL_ARCHS, ASSIGNED_ARCHS,
                                          all_configs, get_config)

__all__ = ["ALL_ARCHS", "ASSIGNED_ARCHS", "ClientConfig", "DECODE_32K",
           "DPConfig", "INPUT_SHAPES", "InputShape", "LONG_500K",
           "MULTI_POD", "MeshConfig", "ModelConfig", "PREFILL_32K",
           "SINGLE_POD", "TRAIN_4K", "all_configs", "get_config"]
