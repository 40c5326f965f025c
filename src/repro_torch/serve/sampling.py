"""Per-session sampling and suggestion-strip candidates.

The engine and the single-session reference both sample through these
functions, so their agreement is a property of the inputs (logits, session
key, step index, temperature), not of the caller.

The reference draws from JAX's threefry, which the port cannot reproduce.
It keeps the contract instead: token *t* of a session depends only on
(logits, session key, t, temperature) — never on its slot, the batch width
or the admission time. Sampling is Gumbel-max: ``argmax(logits / temp + G)``
with G = −log(−log U), where U comes from a counter-based integer hash of
(key, t, vocab id). The hash is plain integer arithmetic on int64 tensors
(32-bit words, every product kept below 2^63), so it gives the same bits on
the CPU and on the card, whatever the batch.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2^32 for 32-bit words held in int64, without overflow:
    x = x_hi·2^16 + x_lo, so x·c ≡ x_lo·c + ((x_hi·c) mod 2^16)·2^16."""
    lo = (x & 0xFFFF) * c
    hi = (((x >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mixer (two xor-shift-multiply rounds) on int64
    tensors holding 32-bit words."""
    x = x & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(keys: torch.Tensor, ts: torch.Tensor, vocab: int
                 ) -> torch.Tensor:
    """(B, vocab) float32 Gumbel noise for rows keyed by ``keys`` (B, 2)
    at step ``ts`` (B,)."""
    keys = keys.to(torch.int64)
    row = hash32(keys[:, 0] ^ hash32(keys[:, 1] ^ hash32(ts.to(torch.int64))))
    col = hash32(torch.arange(vocab, dtype=torch.int64, device=keys.device)
                 ^ 0x9E3779B9)
    bits = hash32(row[:, None] ^ col[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # (0, 1)
    return -torch.log(-torch.log(u))


def sample_tokens(logits, keys, ts, temperatures):
    """One token per row. logits (B, V) float32; keys (B, 2) — per-row
    session keys; ts (B,) — per-row step index; temperatures (B,) — rows
    with ``temp <= 0`` take the greedy argmax (lowest index on ties), the
    rest sample ``softmax(logits / temp)``."""
    greedy = torch.argmax(logits, dim=-1)
    hot = temperatures > 0.0
    safe_t = torch.where(hot, temperatures, torch.ones_like(temperatures))
    noisy = logits / safe_t[:, None] + gumbel_noise(keys, ts, logits.shape[1])
    sampled = torch.argmax(noisy, dim=-1)
    return torch.where(hot, sampled, greedy).to(torch.int32)


def topk_ids(logits, k: int):
    """Ranked candidates: (B, V) → (B, k) int32, best first, ties toward
    the lower index (so candidate 0 is always the greedy token). Built from
    ``k`` argmaxes, which promise the first maximal index; ``torch.topk``
    makes no promise on ties."""
    work = logits.clone()
    ids = []
    for _ in range(k):
        idx = torch.argmax(work, dim=-1, keepdim=True)
        ids.append(idx)
        work.scatter_(1, idx, float("-inf"))
    return torch.cat(ids, dim=1).to(torch.int32)


def fold_in(key, data: int):
    """A derived (2,) key for sub-stream ``data`` of ``key`` (host-side,
    numpy in and out)."""
    k = torch.as_tensor(np.asarray(key, np.int64))
    d = torch.tensor(int(data) & _MASK32, dtype=torch.int64)
    out = torch.stack([hash32(k[0] ^ hash32(d)), hash32(k[1] ^ d)])
    return out.numpy().astype(np.uint32)
