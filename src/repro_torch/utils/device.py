"""Device resolution: ``"cuda"`` by default, the CPU only on request.

There is no silent fallback: asking for CUDA on a host without a usable GPU
raises, so a run never carries on quietly on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``. Raises ``RuntimeError`` for a CUDA device when
    ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA GPU is available "
            f"(torch {torch.__version__}); pass device='cpu' to run the "
            f"plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {str(dev)!r}")
    return dev
