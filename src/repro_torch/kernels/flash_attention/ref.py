"""Plain PyTorch version of the flash attention kernel: the CPU path of the
`flash_attention` wrapper and the oracle the CUDA kernel is held against on
the card. It follows the reference's ``attention_ref``: the KV heads repeated
for GQA, a full softmax in float32 under the causal, window and key-length
masks, the output in q's dtype. A row with no valid key gives 0, as the
kernel's ``l == 0`` guard does."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) → (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qt = q.transpose(1, 2).float()                          # (B,H,Sq,hd)
    kt = k.transpose(1, 2).repeat_interleave(G, dim=1).float()
    vt = v.transpose(1, 2).repeat_interleave(G, dim=1).float()
    scores = torch.matmul(qt, kt.transpose(-1, -2)) / math.sqrt(hd)
    q_idx = torch.arange(Sq, device=q.device)[:, None]
    k_idx = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_idx <= q_idx
    if window > 0:
        mask &= k_idx > q_idx - window
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1)
    probs = probs * mask.any(dim=-1, keepdim=True)          # empty rows → 0
    out = torch.matmul(probs, vt)
    return out.transpose(1, 2).to(q.dtype)
