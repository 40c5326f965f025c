"""Shared layers of the port: parameter initialisers, norms, RoPE, the plain
GQA attention, the MLPs, vocab padding and the LM loss — the counterparts of
``repro.models.layers``, as plain functions over explicit parameter dicts.

Initialisers draw from an explicit ``torch.Generator`` on the generator's own
device and move the result to ``device``: a CPU generator gives the same
weights for a seed whatever the device (the CIFG-LSTM's callers pass one), a
generator on the card draws a full-width model there without a pass through
the host. They follow the reference's distributions, not its bits: JAX's
threefry streams cannot be reproduced by torch's generator.

Products run in the activations' dtype (the compute dtype) through
`matmul`: a weight is cast with ``.to(x.dtype)``, which is free when the
parameter set already carries compute-dtype copies
(`repro_torch.utils.params`).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    return ((vocab + multiple - 1) // multiple) * multiple


def dense_init(generator: torch.Generator, shape: Sequence[int],
               in_dim: Optional[int] = None, *, device=None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1/in_dim) cut at ±2 std."""
    if in_dim is None:
        in_dim = shape[0]
    std = 1.0 / math.sqrt(in_dim)
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return w.to(device)


def embed_init(generator: torch.Generator, shape: Sequence[int], *,
               device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * 0.02
    return w.to(device)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype, summed in float32. On the card that is one
    product in that dtype; on the CPU it is the product of the float32
    values, rounded once, which is the same arithmetic up to the order of
    the sum (and the CPU's bfloat16 products are slow)."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


# ---------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def norm(x: torch.Tensor, p, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"])


def norm_init(d: int, kind: str, *, device=None):
    ones = torch.ones((d,), dtype=torch.float32, device=device)
    if kind == "rmsnorm":
        return {"scale": ones}
    return {"scale": ones,
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def stacked_norm_init(n: int, d: int, kind: str, *, device=None):
    """`norm_init` for ``n`` stacked layers: leaves (n, d)."""
    return {k: v.expand(n, d).contiguous()
            for k, v in norm_init(d, kind, device=device).items()}


# ---------------------------------------------------------------- RoPE


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, hd); positions: (..., S) ints."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freqs        # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------ attention (plain, GQA)

NEG_INF = -1e30


def _attend_block(q, k, v, q_pos, kv_pos, kv_len, window, causal):
    """All queries of the block against all KV. q: (B,Sq,H,hd), k/v:
    (B,Skv,KV,hd) → (B,Sq,H,hd) in v's dtype. Scores and softmax in float32
    (products of compute-dtype values are exact in float32); the
    probabilities are rounded to v's dtype before the PV product, as in the
    reference."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * (1.0 / math.sqrt(hd))
    valid = kv_pos[None, :] >= 0     # ring-buffer slots can be empty
    if kv_len is not None:
        valid = valid & (kv_pos[None, :] < kv_len)
    if causal:
        valid = valid & (kv_pos[None, :] <= q_pos[:, None])
    if window and window > 0:
        valid = valid & (kv_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(valid[None, None, None], scores,
                         torch.full((), NEG_INF, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs.float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, H, hd)


def attention(q, k, v, *, q_positions, kv_positions, kv_len=None,
              causal: bool = True, window: int = 0, q_chunk: int = 1024):
    """GQA attention in plain PyTorch, chunked over queries to bound the
    score transient. q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd);
    q_positions (Sq,), kv_positions (Skv,) absolute positions; kv_len a
    count of valid cache entries (``None`` = all valid)."""
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return _attend_block(q, k, v, q_positions, kv_positions, kv_len,
                             window, causal)
    return torch.cat([
        _attend_block(q[:, i:i + q_chunk], k, v, q_positions[i:i + q_chunk],
                      kv_positions, kv_len, window, causal)
        for i in range(0, Sq, q_chunk)], dim=1)


def gqa_init(generator: torch.Generator, d_model: int, n_heads: int,
             n_kv: int, head_dim: int, *, device=None):
    return {
        "wq": dense_init(generator, (d_model, n_heads * head_dim),
                         device=device),
        "wk": dense_init(generator, (d_model, n_kv * head_dim),
                         device=device),
        "wv": dense_init(generator, (d_model, n_kv * head_dim),
                         device=device),
        "wo": dense_init(generator, (n_heads * head_dim, d_model),
                         in_dim=n_heads * head_dim, device=device),
    }


def gqa_project(x, p, n_heads: int, n_kv: int, head_dim: int, positions,
                theta: float):
    """x: (B,S,d) → q (B,S,H,hd), k, v (B,S,KV,hd), RoPE applied."""
    B, S, _ = x.shape
    q = matmul(x, p["wq"]).reshape(B, S, n_heads, head_dim)
    k = matmul(x, p["wk"]).reshape(B, S, n_kv, head_dim)
    v = matmul(x, p["wv"]).reshape(B, S, n_kv, head_dim)
    return rope(q, positions, theta), rope(k, positions, theta), v


# ---------------------------------------------------------------- MLPs


def swiglu_init(generator: torch.Generator, d_model: int, d_ff: int, *,
                device=None):
    return {
        "w_gate": dense_init(generator, (d_model, d_ff), device=device),
        "w_up": dense_init(generator, (d_model, d_ff), device=device),
        "w_down": dense_init(generator, (d_ff, d_model), in_dim=d_ff,
                             device=device),
    }


def swiglu(x, p):
    g = F.silu(matmul(x, p["w_gate"]))
    u = matmul(x, p["w_up"])
    return matmul(g * u, p["w_down"])


def gelu_mlp_init(generator: torch.Generator, d_model: int, d_ff: int, *,
                  device=None):
    return {
        "w_in": dense_init(generator, (d_model, d_ff), device=device),
        "b_in": torch.zeros((d_ff,), dtype=torch.float32, device=device),
        "w_out": dense_init(generator, (d_ff, d_model), in_dim=d_ff,
                            device=device),
        "b_out": torch.zeros((d_model,), dtype=torch.float32, device=device),
    }


def gelu_mlp(x, p):
    """``jax.nn.gelu``'s default is the tanh approximation."""
    cd = x.dtype
    h = F.gelu(matmul(x, p["w_in"]) + p["b_in"].to(cd), approximate="tanh")
    return matmul(h, p["w_out"]) + p["b_out"].to(cd)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             *, device=None):
    if act == "swiglu":
        return swiglu_init(generator, d_model, d_ff, device=device)
    return gelu_mlp_init(generator, d_model, d_ff, device=device)


def mlp(x, p, act: str):
    return swiglu(x, p) if act == "swiglu" else gelu_mlp(x, p)


# ------------------------------------------------------- vocab and loss


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
