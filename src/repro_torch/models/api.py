"""Unified model interface of the port.

Serving contract (`repro_torch.serve`): a model is *continuous-batching
capable* when every decode-cache leaf is per-row (leading dim = batch) and
``decode_step`` treats rows independently. A model whose prefill honours
``batch["length"]`` — returning state and last-position logits bitwise
identical to an unpadded prefill of that length — gets bucket-padded
admission; the engine checks this with a probe at construction.

Training contract (`repro_torch.fl.client`): ``loss_fn(params, batch)`` is a
float32 scalar differentiable in every leaf of ``params``. A model whose
``client_loss_fn`` is set also trains a chunk of clients as one batched
program: ``client_loss_fn(params_c, batch_c)`` takes parameters whose every
leaf has a leading client axis C and batch leaves (C, B, S), and returns the
per-client losses (C,), client c's computed as ``loss_fn`` computes one
client's and the same bits whatever C is (the reference's vmapped
``loss_fn``). Every family's ``build`` sets it; a model rebuilt with
``client_loss_fn=None`` trains the chunk's clients one after another.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

from repro_torch.configs.base import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]         # (generator, *, device) -> params
    forward: Callable[..., Any]      # (params, batch) -> logits (B,S,Vpad)
    loss_fn: Callable[..., Any]      # (params, batch) -> scalar f32
    init_cache: Callable[..., Any]   # (batch_size, max_len, *, device) -> cache
    prefill: Callable[..., Any]      # (params, batch) -> (logits (B,Vpad), cache)
    decode_step: Callable[..., Any]  # (params, tokens (B,), cache) -> (logits, cache)
    compute_copies: Callable[..., Any]  # (params, dtype) -> params["compute"]
    client_loss_fn: Optional[Callable[..., Any]] = None  # (params_c, batch_c) -> (C,)
