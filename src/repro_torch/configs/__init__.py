from repro_torch.configs.base import ClientConfig, DPConfig, ModelConfig
from repro_torch.configs.registry import get_config

__all__ = ["ClientConfig", "DPConfig", "ModelConfig", "get_config"]
