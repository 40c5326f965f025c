"""Shared layer helpers: vocab padding, parameter initialisers and the LM loss.

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


NEG_INF = -1e30


def lm_loss(logits: torch.Tensor, labels, vocab: int, mask=None
            ) -> torch.Tensor:
    """Cross-entropy over a padded vocab axis, as the reference's
    ``lm_loss``: logits (B, S, Vpad), labels (B, S) ints, mask (B, S) float
    or ``None``. Padded columns are masked to −1e30, the logsumexp runs in
    float32, the true logit is a where-reduce over the vocab axis (one
    nonzero term, so the same bits as a gather), and the masked mean divides
    by ``max(Σ mask, 1)``."""
    vpad = logits.shape[-1]
    lf = logits.float()
    vocab_ids = torch.arange(vpad, device=lf.device)
    if vpad > vocab:
        lf = lf.masked_fill(vocab_ids >= vocab, NEG_INF)
    lse = torch.logsumexp(lf, dim=-1)
    labels = torch.as_tensor(labels, device=lf.device).long()
    true_logit = torch.where(labels[..., None] == vocab_ids, lf,
                             torch.zeros((), device=lf.device)).sum(dim=-1)
    nll = lse - true_logit
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=lf.device, dtype=torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
