"""Shared layer helpers: vocab padding and parameter initialisers.

Initialisers draw on the CPU from an explicit ``torch.Generator`` (so a seed
gives the same weights whatever the device) and move the result to
``device``. They follow the reference's distributions, not its bits: JAX's
threefry streams cannot be reproduced by torch's generator.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_dim: Optional[int] = None, *, device=None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/in_dim) cut at ±2 std."""
    if in_dim is None:
        in_dim = shape[0]
    std = 1.0 / math.sqrt(in_dim)
    w = torch.empty(tuple(shape), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return w.to(device)


def embed_init(generator: torch.Generator, shape: Sequence[int], *,
               device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator,
                    dtype=torch.float32) * 0.02
    return w.to(device)
