"""Dense decoder-only transformer (granite-3-2b, phi3-mini/medium,
stablelm-12b): the port of ``repro.models.transformer``.

The layers' parameters are stacked on a leading ``(n_layers, …)`` axis, as
in the reference, so its parameter tree crosses over as it is
(`repro_torch.utils.params.from_jax_params`); ``forward`` loops over the
layers. The prefill's causal (or sliding-window) attention runs the
hand-written flash kernel (`repro_torch.kernels.flash_attention`) for CUDA
tensors, once per layer, and the plain `layers.attention` on the CPU. The
decode step's attention over the cache (one query, ``kv_len = pos + 1``) is
the plain `layers.attention` on every device, as in the reference, which
has no kernel for it either.

The decode cache is ``k``, ``v`` (n_layers, B, T, KV, hd) in the compute
dtype and a shared scalar ``pos``. With ``attn_window > 0`` and a cache no
longer than the window, it is a ring of slots (`layers.ring_positions`).
The decode step writes the new token's K and V into ``k`` and ``v`` in
place (the reference returns updated copies), at a start index clamped as
``dynamic_update_slice`` clamps it: the returned cache holds the same two
tensors.

The attention block (`_attn_block`, `_attn_step`) is shared with the MoE
family (`repro_torch.models.moe`) and the hybrid's shared block
(`repro_torch.models.hybrid`); `attend`, the choice between the kernel and
the plain attention, also with the encoder-decoder
(`repro_torch.models.encdec`).

Training: ``loss_fn`` recomputes each layer in the backward (``remat``, on
by default as in the reference, `layers.remat_call`). On the card the
flash kernel's output is differentiable through the plain attention's
gradient (`repro_torch.kernels.recompute`), so under remat a training step
launches the kernel twice per layer: the forward, then the recomputation.
``forward`` also takes a chunk of clients (parameters with a leading
client axis, `layers.is_chunk`), the families' ``client_loss_fn``
(`layers.chunk_loss`): twice per layer for the whole chunk.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.models.embed import (embed_tokens, embedding_init,
                                      head_logits, token_ids)
from repro_torch.sharding.kernel_map import (attention_heads, cache_write,
                                             is_dtensor)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import per_client, torch_dtype
from repro_torch.utils.params import (compute_view, matrix_copies,
                                      with_compute_copies)

# a compute-dtype mirror of every per-layer matrix; "layers" leaves carry
# the stacked layer axis
compute_copies = partial(matrix_copies, stacked=("layers",))


def attn_layers_init(generator: torch.Generator, cfg: ModelConfig, n: int,
                     *, device=None):
    """The pre-norms and GQA projections of ``n`` stacked layers."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(shape):
        return L.stacked_dense_init(generator, n, shape, device=device)

    return {
        "ln1": L.stacked_norm_init(n, d, cfg.norm, device=device),
        "attn": {"wq": dense((d, H)), "wk": dense((d, KV)),
                 "wv": dense((d, KV)), "wo": dense((H, d))},
        "ln2": L.stacked_norm_init(n, d, cfg.norm, device=device),
    }


def _mlp_init(generator: torch.Generator, cfg: ModelConfig, n: int, *,
              device=None):
    d, f = cfg.d_model, cfg.d_ff

    def dense(shape):
        return L.stacked_dense_init(generator, n, shape, device=device)

    if cfg.act == "swiglu":
        return {"w_gate": dense((d, f)), "w_up": dense((d, f)),
                "w_down": dense((f, d))}
    zeros = partial(torch.zeros, dtype=torch.float32, device=device)
    return {"w_in": dense((d, f)), "b_in": zeros((n, f)),
            "w_out": dense((f, d)), "b_out": zeros((n, d))}


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``, with the compute-dtype copies made."""
    dev = resolve_device(device)
    layers = attn_layers_init(generator, cfg, cfg.n_layers, device=dev)
    layers["mlp"] = _mlp_init(generator, cfg, cfg.n_layers, device=dev)
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        "layers": layers,
        "ln_f": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def attend(q, k, v, *, causal: bool, window: int = 0):
    """Attention of whole sequences, queries and keys at positions from 0:
    the flash kernel for CUDA tensors, the plain `layers.attention` on the
    CPU. q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd). DTensors over the model
    axis attend each rank's local heads (`sharding.kernel_map`). A chunk of
    clients, q (C, B, Sq, H, hd): on the card one launch with (C, B)
    folded into the kernel's batch (every (row, head, query tile) is
    computed alone) and the plain gradient a client at a time
    (``clients``); on the CPU a client at a time."""
    if is_dtensor(q):
        return attention_heads(partial(attend, causal=causal, window=window),
                               q, k, v)
    if q.dim() == 5:
        if q.device.type != "cuda":
            return per_client(partial(attend, causal=causal, window=window),
                              q, k, v)
        out = flash_attention(q.flatten(0, 1), k.flatten(0, 1),
                              v.flatten(0, 1), causal=causal, window=window,
                              clients=q.shape[0])
        return out.unflatten(0, q.shape[:2])
    if q.device.type == "cuda":
        return flash_attention(q, k, v, causal=causal, window=window)
    return L.attention(
        q, k, v, causal=causal, window=window,
        q_positions=torch.arange(q.shape[1], dtype=torch.int32),
        kv_positions=torch.arange(k.shape[1], dtype=torch.int32))


def _attn_block(x, lp, cfg: ModelConfig, positions, *, window: int):
    """Pre-norm attention over a whole sequence (positions 0..S-1) with its
    residual (`attend`, causal). Returns (x, (k, v))."""
    h = L.norm(x, lp["ln1"], cfg.norm)
    q, k, v = L.gqa_project(h, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, positions, cfg.rope_theta)
    a = attend(q, k, v, causal=True, window=window)
    return x + L.matmul(a.flatten(-2), lp["attn"]["wo"]), (k, v)


def _layer_fwd(x, lp, cfg: ModelConfig, positions, *, window: int):
    """One decoder layer: (x, lp) → (x, (k, v))."""
    x, kv = _attn_block(x, lp, cfg, positions, window=window)
    h = L.norm(x, lp["ln2"], cfg.norm)
    return x + L.mlp(h, lp["mlp"], cfg.act), kv


def _embed_batch(cw, batch, cfg: ModelConfig):
    """Early fusion: for the VLM, precomputed image-patch embeddings replace
    the embeddings of the first ``n_image`` positions (of each client's
    rows, for a chunk)."""
    cd = torch_dtype(cfg.compute_dtype)
    x = embed_tokens(cw["embed"], token_ids(cw, batch["tokens"]), cd)
    if "image_embeds" in batch:
        img = torch.as_tensor(batch["image_embeds"], device=x.device).to(cd)
        x = torch.cat([img, x[..., img.shape[-2]:, :]], dim=-2)
    return x


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    """Logits (B, S, Vpad) float32; with ``collect_cache`` also every
    layer's (k, v), stacked to (n_layers, B, S, KV, hd). ``remat``
    recomputes each layer in the backward. Parameters with a leading
    client axis (`layers.is_chunk`) and batch leaves (C, B, S) give each
    client's logits (C, B, S, Vpad) from its own weights."""
    cw = compute_view(params)
    x = _embed_batch(cw, batch, cfg)
    positions = torch.arange(x.shape[-2], dtype=torch.int32,
                             device=x.device)
    layer = partial(_layer_fwd, cfg=cfg, positions=positions,
                    window=cfg.attn_window)
    kvs = []
    for lp in L.unstack_layers(cw["layers"], int(L.is_chunk(cw))):
        x, kv = L.remat_call(layer, x, lp, remat=remat)
        if collect_cache:
            kvs.append(kv)
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)
    if not collect_cache:
        return logits
    return logits, (torch.stack([k for k, _ in kvs]),
                    torch.stack([v for _, v in kvs]))


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True):
    logits = forward(params, batch, cfg, remat=remat)
    return L.lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Window attention needs only a ring of ``attn_window`` slots."""
    if cfg.attn_window > 0:
        return min(max_len, cfg.attn_window)
    return max_len


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch_size, cache_len(cfg, max_len),
             cfg.n_kv_heads, cfg.head_dim)
    cd = torch_dtype(cfg.compute_dtype)
    return {"k": torch.zeros(shape, dtype=cd, device=dev),
            "v": torch.zeros(shape, dtype=cd, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def _pad_kv(a: torch.Tensor, max_len) -> torch.Tensor:
    """Zero-pad a prefill KV stack (L, B, S, KV, hd) to ``max_len`` slots on
    the sequence axis (unchanged when ``max_len`` is None or <= S)."""
    S = a.shape[2]
    if max_len is None or max_len <= S:
        return a
    return F.pad(a, (0, 0, 0, 0, 0, max_len - S))


def _fit_kv(a: torch.Tensor, cfg: ModelConfig, max_len) -> torch.Tensor:
    """Fit a prefill KV stack into the decode cache: ring-packed for window
    attention, zero-padded when the cache is longer than the prompt."""
    if cfg.attn_window > 0:
        alloc = cache_len(cfg, max(max_len or 0, a.shape[2]))
        return _pad_kv(L.ring_pack(a, alloc), alloc)
    return _pad_kv(a, max_len)


def prefill_cache(ks, vs, tokens, cfg: ModelConfig, max_len):
    """The decode cache after a prefill of ``tokens`` (B, S)."""
    return {"k": _fit_kv(ks, cfg, max_len), "v": _fit_kv(vs, cfg, max_len),
            "pos": torch.tensor(tokens.shape[1], dtype=torch.int32,
                                device=ks.device)}


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    """Prompt prefill → (last-position logits (B, Vpad), decode cache with
    ``max_len`` KV slots per layer, or the ring)."""
    logits, (ks, vs) = forward(params, batch, cfg, collect_cache=True)
    return logits[:, -1, :], prefill_cache(ks, vs, batch["tokens"], cfg,
                                           max_len)


def decode_slots(cfg: ModelConfig, pos: torch.Tensor, max_len: int):
    """Where the token at ``pos`` is written, (1,) int64, and the position
    each of the cache's ``max_len`` slots holds: a ring for window attention
    with a cache no longer than the window, else slot = position, with the
    write clamped to the last slot as ``dynamic_update_slice`` clamps it."""
    if cfg.attn_window > 0 and max_len <= cfg.attn_window:
        return (torch.remainder(pos, max_len).reshape(1).long(),
                L.ring_positions(pos, max_len))
    return (pos.reshape(1).long().clamp(max=max_len - 1),
            torch.arange(max_len, dtype=torch.int32, device=pos.device))


def _attn_step(x, lp, cfg: ModelConfig, kc, vc, pos, slot, kv_positions):
    """Pre-norm attention of one token per row at position ``pos`` over a
    layer's cache ``kc``, ``vc`` (B, T, KV, hd), with its residual. Writes
    the token's K and V into slot ``slot`` of the cache in place."""
    h = L.norm(x, lp["ln1"], cfg.norm)
    q_positions = pos.reshape(1)
    q, k, v = L.gqa_project(h, lp["attn"], cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, q_positions, cfg.rope_theta)
    cache_write(kc, slot, k)
    cache_write(vc, slot, v)
    a = L.attention(q, kc, vc, q_positions=q_positions,
                    kv_positions=kv_positions, kv_len=pos + 1, causal=True,
                    window=cfg.attn_window)
    return x + L.matmul(a.reshape(x.shape[0], 1, -1), lp["attn"]["wo"])


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """One token (B,) for every row at the cache's position ``pos`` →
    (logits (B, Vpad), cache). Writes into ``cache["k"]`` and
    ``cache["v"]`` in place."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    pos = cache["pos"]
    x = embed_tokens(cw["embed"], token_ids(cw, tokens)[:, None], cd)
    slot, kv_positions = decode_slots(cfg, pos, cache["k"].shape[2])
    for i, lp in enumerate(L.unstack_layers(cw["layers"])):
        x = _attn_step(x, lp, cfg, cache["k"][i], cache["v"][i], pos, slot,
                       kv_positions)
        h = L.norm(x, lp["ln2"], cfg.norm)
        x = x + L.mlp(h, lp["mlp"], cfg.act)
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)[:, 0, :]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=partial(init, cfg=cfg),
        forward=partial(forward, cfg=cfg),
        loss_fn=partial(loss_fn, cfg=cfg),
        init_cache=partial(init_cache, cfg),
        prefill=partial(prefill, cfg=cfg),
        decode_step=partial(decode_step, cfg=cfg),
        compute_copies=compute_copies,
        client_loss_fn=partial(L.chunk_loss, forward, cfg=cfg),
    )
