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


def clip_accumulate_chunk_ref(acc: torch.Tensor, deltas, factors
                              ) -> torch.Tensor:
    """(((acc + f₀·Δ₀) + f₁·Δ₁) + …): the slots folded left to right, each
    step a rounded product then a rounded sum (``reduction.slot_fold``'s
    association, the chunk kernel's arithmetic)."""
    out = acc.float()
    for c, delta in enumerate(deltas):
        out = out + factors[c] * delta.float()
    return out


def clip_factor_ref(sumsq, clip_norm: float) -> torch.Tensor:
    """min(1, S / max(√sumsq, 1e-12)) — a device scalar, no host sync."""
    norm = torch.sqrt(sumsq)
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def sumsq_chunk_ref(leaves_per_client, clip_norm: float, scales=None):
    """The plain version of ``sumsq_chunk``: per client, the leaves' sums
    of squares added in order from 0 (``fused_sumsq``), the norm
    ``sqrt(ss)`` and the factor ``clip_factor_ref(ss, S)·scale`` →
    (ss, norms, factors), each (C,) float32. ``scales``: a (C,) tensor or
    None (no mask)."""
    ss = torch.stack([sum(sumsq_ref(x) for x in leaves)
                      for leaves in leaves_per_client])
    factors = clip_factor_ref(ss, clip_norm)
    if scales is not None:
        factors = factors * scales
    return ss, torch.sqrt(ss), factors
