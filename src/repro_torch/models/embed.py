"""Token embedding / LM head with a padded vocab (a multiple of 256).

The tied-embedding logits product ``(B, d) @ (d, Vpad)`` is a plain matrix
product; it runs through `rowstable_mm` in float32 over compute-dtype
operands, which is the reference's ``preferred_element_type=float32``.

The row gather's gradient is a one-hot product (`EmbedRows`), not PyTorch's
accumulating index_put: that one adds rows with atomics on CUDA, in an order
that changes run to run, and the training path's sums must come out the
same bits every time (`repro_torch.fl.client`).
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


class EmbedRows(torch.autograd.Function):
    """``table[ids]`` whose backward is ``one_hot(ids)ᵀ @ grad``: a fixed
    product, so the table's gradient has the same bits on every run."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        flat = grad.reshape(ids.numel(), -1)
        onehot = torch.nn.functional.one_hot(ids.reshape(-1), ctx.rows)
        return onehot.to(flat.dtype).t().mm(flat), None


def embed_tokens(p, tokens: torch.Tensor, compute_dtype: torch.dtype
                 ) -> torch.Tensor:
    return EmbedRows.apply(p["tok"], tokens).to(compute_dtype)


def lm_logits(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) → logits (B, S, Vpad) in float32. The head is rounded
    to ``x.dtype`` as in the reference (a no-op for weights that are
    already compute-dtype values held in float32)."""
    w = p.get("head", p["tok"])
    B, S, d = x.shape
    logits = rowstable_mm(x.reshape(B * S, d), round_to(w, x.dtype).t())
    return logits.reshape(B, S, -1)
