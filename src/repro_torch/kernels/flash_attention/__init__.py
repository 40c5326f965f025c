from repro_torch.kernels.flash_attention.ops import LAUNCHES, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_ref"]
