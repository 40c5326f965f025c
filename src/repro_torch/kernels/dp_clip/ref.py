"""Plain PyTorch versions of the dp_clip kernels (the reference's
``dp_clip/ref.py``): the CPU path of their wrappers and the oracle the CUDA
kernels are held against on the card."""
from __future__ import annotations

import torch


def sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def clip_accumulate_ref(acc: torch.Tensor, delta: torch.Tensor,
                        factor) -> torch.Tensor:
    """acc + factor·delta as two rounded operations (a product, then a
    sum), the kernel's arithmetic."""
    return acc.float() + factor * delta.float()


def clip_factor_ref(sumsq, clip_norm: float) -> torch.Tensor:
    """min(1, S / max(√sumsq, 1e-12)) — a device scalar, no host sync."""
    norm = torch.sqrt(sumsq)
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)
