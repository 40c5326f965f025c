"""Single-session reference decode path.

One session, batch width 1, an explicit Python loop: prefill the prompt,
emit token 0 from the prefill logits, then one ``decode_step`` per token.
This is the plain semantics the continuous-batching engine must reproduce
token for token — the same per-session sampling (`repro_torch.serve.sampling`),
the same candidate ranking, the same hot-swap rule: a ``swaps=[(t, p), ...]``
entry means tokens with index ``>= t`` are computed by ``p`` while the
recurrent state carries over, which is what an in-flight session sees when
a new checkpoint is promoted between ticks.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve import sampling
from repro_torch.serve.frontend import make_session_key
from repro_torch.utils.params import param_device, with_compute_copies


def reference_generate(model: Model, params, prompt: Sequence[int],
                       steps: int, *, temperature: float = 0.0,
                       seed: Optional[int] = None, top_k: int = 3,
                       swaps: Sequence[Tuple[int, Any]] = ()):
    """Generate ``steps`` tokens for one session on the parameters' device.

    Returns ``(tokens, candidates)``: the emitted ids (length ``steps``) and
    the ranked ``(steps, top_k)`` candidate ids per position. ``(t, p)`` in
    ``swaps`` means params ``p`` compute every token with index ``>= t`` (a
    swap at ``t = 0`` covers the prefill too)."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    if temperature > 0.0 and seed is None:
        raise ValueError("temperature>0 sampling needs a session seed")
    if steps == 0:
        return (), np.zeros((0, top_k), np.int32)
    cd = model.cfg.compute_dtype
    vocab = model.cfg.vocab
    params = with_compute_copies(params, cd, model.compute_copies)
    swaps = [(t, with_compute_copies(p, cd, model.compute_copies))
             for t, p in sorted(swaps, key=lambda sw: sw[0])]

    def params_at(t):
        cur = params
        for at, p in swaps:
            if t >= at:
                cur = p
        return cur

    dev = param_device(params)
    key = torch.tensor(make_session_key(seed)[None].astype(np.int64),
                       device=dev)
    temp = torch.full((1,), temperature, dtype=torch.float32, device=dev)
    last, cache = model.prefill(
        params_at(0),
        {"tokens": torch.tensor([list(prompt)], dtype=torch.long,
                                device=dev)})
    tokens: List[int] = []
    cands: List[np.ndarray] = []
    cur = None
    for t in range(steps):
        if t > 0:
            last, cache = model.decode_step(params_at(t), cur, cache)
        lg = last[:, :vocab]
        cur = sampling.sample_tokens(
            lg, key, torch.full((1,), t, dtype=torch.int64, device=dev), temp)
        tokens.append(int(cur[0]))
        cands.append(sampling.topk_ids(lg, top_k)[0].cpu().numpy())
    return tuple(tokens), np.stack(cands).astype(np.int32)
