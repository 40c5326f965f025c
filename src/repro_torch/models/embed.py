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
from repro_torch.utils.numerics import per_client, round_to, rowstable_mm


def embedding_init(generator: torch.Generator, cfg: ModelConfig, *,
                   device=None):
    vpad = pad_vocab(cfg.vocab)
    p = {"tok": embed_init(generator, (vpad, cfg.d_model), device=device)}
    if not cfg.tie_embeddings:
        p["head"] = embed_init(generator, (vpad, cfg.d_model), device=device)
    return p


class EmbedRows(torch.autograd.Function):
    """``table[ids]`` whose backward is ``one_hot(ids)ᵀ @ grad``: a fixed
    product, so the table's gradient has the same bits on every run.

    With a client axis (a chunk of clients, each with its own table):
    table (C, V, d), ids (C, …) → (C, …, d), client c's rows from its own
    table; the backward is one product a client (`per_client`: a
    client's (V, d) gradient is the largest product of a chunk, so no
    client is padded), each client's gradient the bits of its one-client
    call."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[-2]
        ctx.clients = table.dim() == 3
        if ctx.clients:
            clients = torch.arange(table.shape[0], device=ids.device)
            return table[clients.reshape((-1,) + (1,) * (ids.dim() - 1)),
                         ids]
        return table.index_select(0, ids.reshape(-1)).reshape(
            tuple(ids.shape) + tuple(table.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if ctx.clients:
            C = ids.shape[0]
            flat = grad.reshape(C, ids[0].numel(), -1)
            onehot = torch.zeros((C, ids[0].numel(), ctx.rows),
                                 dtype=flat.dtype, device=flat.device)
            onehot.scatter_(2, ids.reshape(C, -1, 1), 1.0)
            return per_client(torch.mm, onehot.transpose(1, 2), flat), None
        flat = grad.reshape(ids.numel(), -1)
        onehot = torch.nn.functional.one_hot(ids.reshape(-1), ctx.rows)
        return onehot.to(flat.dtype).t().mm(flat), None


def embed_tokens(p, tokens: torch.Tensor, compute_dtype: torch.dtype
                 ) -> torch.Tensor:
    return EmbedRows.apply(p["tok"], tokens).to(compute_dtype)


def token_ids(params, tokens) -> torch.Tensor:
    """``tokens`` as int64 on the device of a model's parameters (read from
    ``params["ln_f"]``)."""
    return torch.as_tensor(tokens, device=params["ln_f"]["scale"].device
                           ).long()


def head_logits(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d) → (B,S,Vpad) float32 against the tied (or separate) head
    of the embedding parameters ``p``, in x's dtype: the serving families'
    logits. On the CPU the float32 product of those values, as the
    reference's ``preferred_element_type=float32``; on the card one product
    in x's dtype (float32 sums, the output rounded to x's dtype). A head
    with a leading client axis (C, Vpad, d) is a chunk of clients, x
    (C, B, S, d): each client's logits against its own head, its
    one-client call (`per_client`)."""
    w = p.get("head", p["tok"]).to(x.dtype)
    if w.dim() == 3:
        return per_client(lambda wc, xc: head_logits({"tok": wc}, xc), w, x)
    if x.device.type == "cpu":
        return x.float() @ w.float().t()
    return (x @ w.t()).float()


def lm_logits(p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) → logits (B, S, Vpad) in float32. The head is rounded
    to ``x.dtype`` as in the reference (a no-op for weights that are
    already compute-dtype values held in float32)."""
    w = p.get("head", p["tok"])
    B, S, d = x.shape
    logits = rowstable_mm(x.reshape(B * S, d), round_to(w, x.dtype).t())
    return logits.reshape(B, S, -1)
