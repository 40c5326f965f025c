"""Dense transformer helpers (``repro.models.transformer``). So far only what
the hybrid's prefill needs: `_pad_kv`. The dense model arrives with its own
slice of the port."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_kv(a: torch.Tensor, max_len) -> torch.Tensor:
    """Zero-pad a prefill KV stack (L, B, S, KV, hd) to ``max_len`` slots on
    the sequence axis (unchanged when ``max_len`` is None or <= S)."""
    S = a.shape[2]
    if max_len is None or max_len <= S:
        return a
    return F.pad(a, (0, 0, 0, 0, 0, max_len - S))
