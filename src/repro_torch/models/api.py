"""Unified model interface of the port.

Serving contract (`repro_torch.serve`): a model is *continuous-batching
capable* when every decode-cache leaf is per-row (leading dim = batch) and
``decode_step`` treats rows independently. A model whose prefill honours
``batch["length"]`` — returning state and last-position logits bitwise
identical to an unpadded prefill of that length — gets bucket-padded
admission; the engine checks this with a probe at construction.

``loss_fn`` arrives with the training slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]         # (generator, *, device) -> params
    forward: Callable[..., Any]      # (params, batch) -> logits (B,S,Vpad)
    init_cache: Callable[..., Any]   # (batch_size, max_len, *, device) -> cache
    prefill: Callable[..., Any]      # (params, batch) -> (logits (B,Vpad), cache)
    decode_step: Callable[..., Any]  # (params, tokens (B,), cache) -> (logits, cache)
