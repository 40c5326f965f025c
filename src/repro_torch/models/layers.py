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
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.utils.numerics import (client_apply, client_matmul,
                                        client_vector, compute_mm)


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


def stacked_dense_init(generator: torch.Generator, n: int,
                       shape: Sequence[int], in_dim: Optional[int] = None, *,
                       device=None) -> torch.Tensor:
    """``n`` stacked `dense_init` matrices of ``shape`` (fan-in ``in_dim``,
    default ``shape[0]``), drawn in one call: the leaves of a parameter
    tree whose layers lie on a leading axis."""
    return dense_init(generator, (n,) + tuple(shape),
                      in_dim=in_dim or shape[0], device=device)


def unstack_layers(stacked, axis: int = 0) -> list:
    """Every layer of a stacked parameter tree, as a list of per-layer
    trees (views, no copy). One ``unbind`` per leaf: its backward stacks
    the layers' gradients once, where a separate ``stacked[i]`` per layer
    would each add a zero-filled gradient of the whole stack (at
    granite-3-2b's 40 layers, ~1.3 TB of memory traffic a step). The
    layers lie on ``axis``: 0, or 1 behind a chunk's client axis."""
    if isinstance(stacked, dict):
        parts = {k: unstack_layers(v, axis) for k, v in stacked.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(stacked, axis))


def is_chunk(params) -> bool:
    """Whether a model's parameters carry a leading client axis (a chunk of
    clients, `repro_torch.fl.client`): read from the final norm's scale,
    (d,) for one client and (C, d) for a chunk."""
    return params["ln_f"]["scale"].dim() == 2


def embed_init(generator: torch.Generator, shape: Sequence[int], *,
               device=None) -> torch.Tensor:
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device) * 0.02
    return w.to(device)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype, summed in float32 (`compute_mm`). A
    weight with a leading client axis (C, K, N) is a chunk of clients, x
    (C, …, K): each client's product with its own weight
    (`client_matmul`)."""
    if w.dim() == 3:
        return client_matmul(x, w)
    return compute_mm(x, w)


# ---------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * client_vector(w.float(), out)).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * client_vector(w.float(), out)
            + client_vector(b.float(), out)).to(x.dtype)


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


def sinusoidal_positions(seq_len: int, d: int) -> torch.Tensor:
    """(seq_len, d) float32 sinusoidal table: sin in the even columns, cos
    in the odd ones (interleaved, as the reference's)."""
    pos = torch.arange(seq_len, dtype=torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0), dim / d)
    pe = torch.zeros((seq_len, d), dtype=torch.float32)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def sinusoidal_position_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """The table's row for one position (a 0-d tensor) → (1, d) float32 on
    ``pos``'s device."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    ang = pos.float() / torch.pow(torch.tensor(10_000.0, device=pos.device),
                                  dim / d)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(1, d)


# ---------------------------------------------------------------- remat


def remat_call(fn, *args, remat: bool):
    """``fn(*args)``; with ``remat`` and grad enabled, under
    ``torch.utils.checkpoint`` (non-reentrant): the reference's
    ``jax.checkpoint`` of a layer body. The backward recomputes the body,
    so a kernel inside it launches twice a step; the gradients are the
    same bits as without it."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------ sharding hints


def shard_hint(x, *spec):
    """The reference's ``shard_hint``: a no-op outside a mesh (a plain
    tensor); for a DTensor, a redistribute to ``spec`` over its mesh, each
    entry keeping only the axes the mesh has and, of those, the longest
    tail whose product divides the dim. A spec of another rank than ``x``
    is ignored."""
    from repro_torch.sharding.kernel_map import is_dtensor
    if not is_dtensor(x) or len(spec) != x.dim():
        return x
    from repro_torch.sharding.specs import Spec, placements
    mesh = x.device_mesh
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def fit(entry, dim):
        if entry is None:
            return None
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes)
        while axes:
            if dim % math.prod(sizes[a] for a in axes) == 0:
                return axes if len(axes) > 1 else axes[0]
            axes = axes[1:]
        return None

    fitted = Spec(*(fit(e, d) for e, d in zip(spec, x.shape)))
    return x.redistribute(mesh, placements(fitted, mesh))


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
    count of valid cache entries (``None`` = all valid). DTensors over the
    model axis attend each rank's local heads, as the kernel does
    (`sharding.kernel_map.attention_heads`)."""
    from repro_torch.sharding.kernel_map import attention_heads, is_dtensor
    if is_dtensor(q):
        return attention_heads(
            lambda q, k, v, qp, kp, n: attention(
                q, k, v, q_positions=qp, kv_positions=kp, kv_len=n,
                causal=causal, window=window, q_chunk=q_chunk),
            q, k, v, q_positions, kv_positions, kv_len)
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return _attend_block(q, k, v, q_positions, kv_positions, kv_len,
                             window, causal)
    return torch.cat([
        _attend_block(q[:, i:i + q_chunk], k, v, q_positions[i:i + q_chunk],
                      kv_positions, kv_len, window, causal)
        for i in range(0, Sq, q_chunk)], dim=1)


# Sliding-window decode keeps a ring of W = attn_window KV slots: position p
# lives in slot p % W, and a slot's position follows from the arithmetic.


def ring_positions(pos: torch.Tensor, W: int) -> torch.Tensor:
    """Absolute position held by each of the W ring slots at decode step
    ``pos`` (the new token's position); negative for a slot still empty."""
    i = torch.arange(W, dtype=torch.int32, device=pos.device)
    return pos - torch.remainder(pos - i, W)


def ring_pack(kv: torch.Tensor, W: int, axis: int = 2) -> torch.Tensor:
    """The last W positions of a prefill KV stack (…, S, …) in ring order
    (slot = position % W)."""
    S = kv.shape[axis]
    if S <= W:
        return kv
    return torch.roll(kv.narrow(axis, S - W, W), S % W, dims=axis)


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


def split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """(..., n·hd) → (..., n, hd). A DTensor whose flat dim is sharded
    over a mesh axis that ``n`` does not divide is replicated first: the
    reference reshards at this reshape (granite's 8 KV heads at model 16)."""
    from repro_torch.sharding.kernel_map import is_dtensor
    if is_dtensor(t) and n % t.device_mesh.size():
        from torch.distributed.tensor import Replicate
        t = t.redistribute(t.device_mesh,
                           [Replicate()] * t.device_mesh.ndim)
    return t.reshape(tuple(t.shape[:-1]) + (n, head_dim))


def gqa_project(x, p, n_heads: int, n_kv: int, head_dim: int, positions,
                theta: float):
    """x: (B,S,d) → q (B,S,H,hd), k, v (B,S,KV,hd), RoPE applied."""
    q = split_heads(matmul(x, p["wq"]), n_heads, head_dim)
    k = split_heads(matmul(x, p["wk"]), n_kv, head_dim)
    v = split_heads(matmul(x, p["wv"]), n_kv, head_dim)
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
    g = client_apply(F.silu, matmul(x, p["w_gate"]), p["w_gate"].dim() == 3)
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
    h = matmul(x, p["w_in"])
    h = client_apply(partial(F.gelu, approximate="tanh"),
                     h + client_vector(p["b_in"].to(cd), h),
                     p["w_in"].dim() == 3)
    h = matmul(h, p["w_out"])
    return h + client_vector(p["b_out"].to(cd), h)


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, act: str,
             *, device=None):
    if act == "swiglu":
        return swiglu_init(generator, d_model, d_ff, device=device)
    return gelu_mlp_init(generator, d_model, d_ff, device=device)


def mlp(x, p, act: str):
    return swiglu(x, p) if act == "swiglu" else gelu_mlp(x, p)


# ------------------------------------------------------- vocab and loss


def _token_nll(logits: torch.Tensor, labels, vocab: int) -> torch.Tensor:
    """Per-token −log p(label): logits (…, Vpad), labels (…) → (…) f32."""
    vpad = logits.shape[-1]
    lf = logits.float()
    vocab_ids = torch.arange(vpad, device=lf.device)
    if vpad > vocab:
        lf = lf.masked_fill(vocab_ids >= vocab, NEG_INF)
    lse = torch.logsumexp(lf, dim=-1)
    labels = torch.as_tensor(labels, device=lf.device).long()
    true_logit = torch.where(labels[..., None] == vocab_ids, lf,
                             torch.zeros((), device=lf.device)).sum(dim=-1)
    return lse - true_logit


def lm_loss(logits: torch.Tensor, labels, vocab: int, mask=None
            ) -> torch.Tensor:
    """Cross-entropy over a padded vocab axis, as the reference's
    ``lm_loss``: logits (B, S, Vpad), labels (B, S) ints, mask (B, S) float
    or ``None``. Padded columns are masked to −1e30, the logsumexp runs in
    float32, the true logit is a where-reduce over the vocab axis (one
    nonzero term, so the same bits as a gather), and the masked mean divides
    by ``max(Σ mask, 1)``."""
    nll = _token_nll(logits, labels, vocab)
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=nll.device, dtype=torch.float32)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def chunk_loss(forward, params_c, batch_c, cfg, *, remat: bool = True
               ) -> torch.Tensor:
    """A family's ``client_loss_fn``: the losses (C,) of a chunk of
    clients, each with its own parameters (every leaf with a leading client
    axis C; batch leaves (C, B, S, …)), client c's the same bits whatever C
    is. ``forward`` is the family's, which runs the whole chunk: each
    product with the client's own weights (`matmul`), one kernel launch a
    layer (attention and the SSD scan fold the clients into their
    batch)."""
    logits = forward(params_c, batch_c, cfg, remat=remat)
    return lm_loss_clients(logits, batch_c["labels"], cfg.vocab,
                           batch_c.get("mask"))


def lm_loss_clients(logits: torch.Tensor, labels, vocab: int, mask=None
                    ) -> torch.Tensor:
    """`lm_loss` of each client of a chunk: logits (C, B, S, Vpad), labels
    and mask (C, B, S) → the per-client losses (C,), each the same
    arithmetic over that client's tokens."""
    nll = _token_nll(logits, labels, vocab)
    dims = tuple(range(1, nll.dim()))
    if mask is None:
        return nll.mean(dims)
    mask = torch.as_tensor(mask, device=nll.device, dtype=torch.float32)
    return (nll * mask).sum(dims) / torch.clamp(mask.sum(dims), min=1.0)
