from repro_torch.models.api import Model
from repro_torch.models.registry import build

__all__ = ["Model", "build"]
