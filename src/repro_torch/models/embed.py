"""Token embedding / LM head with a padded vocab (a multiple of 256).

The tied-embedding logits product ``(B, d) @ (d, Vpad)`` is a plain matrix
product; it runs through `rowstable_mm` in float32 over compute-dtype
operands, which is the reference's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import embed_init, pad_vocab
from repro_torch.utils.numerics import round_to, rowstable_mm


def embedding_init(generator: torch.Generator, cfg: ModelConfig, *,
                   device=None):
    vpad = pad_vocab(cfg.vocab)
    p = {"tok": embed_init(generator, (vpad, cfg.d_model), device=device)}
    if not cfg.tie_embeddings:
        p["head"] = embed_init(generator, (vpad, cfg.d_model), device=device)
    return p


def embed_tokens(p, tokens: torch.Tensor, compute_dtype: torch.dtype
                 ) -> torch.Tensor:
    return p["tok"][tokens].to(compute_dtype)


def lm_logits(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) → logits (B, S, Vpad) in float32. The head is rounded
    to ``x.dtype`` as in the reference (a no-op for weights that are
    already compute-dtype values held in float32)."""
    w = p.get("head", p["tok"])
    B, S, d = x.shape
    logits = rowstable_mm(x.reshape(B * S, d), round_to(w, x.dtype).t())
    return logits.reshape(B, S, -1)
