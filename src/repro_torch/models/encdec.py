"""Whisper-style encoder-decoder [arXiv:2212.04356] — whisper-small: the
port of ``repro.models.encdec``.

Transformer backbone only: the mel-spectrogram and conv feature extractor
is a stub, as in the reference; the batch carries precomputed frame
embeddings (B, n_frames, d). Pre-LN layernorm, GELU, sinusoidal positions
(no RoPE), an MHA decoder with causal self-attention and cross-attention to
the encoder's memory.

The layers' parameters are stacked on a leading axis (``enc_layers``
(n_enc_layers, …), ``dec_layers`` (n_layers, …)), as in the reference, so
its parameter tree crosses over as it is
(`repro_torch.utils.params.from_jax_params`). On CUDA tensors three
attentions run the hand-written flash kernel (`transformer.attend`): the
encoder's self-attention (bidirectional, Sq = Sk = n_frames, which need not
be a multiple of the kernel's tiles), the decoder's causal self-attention
and its cross-attention (bidirectional, Sq = the decoder's length, Sk =
n_frames); on the CPU all three are the plain `layers.attention`. The
decode step keeps the plain attention on every device, over the self KV
cache and over the memory's K and V, as the other families' decode steps
do.

``loss_fn`` recomputes each encoder and each decoder layer in the backward
(``remat``, on by default as in the reference), so under remat a training
step launches flash twice per attention: the forward, then the
recomputation.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import Model
from repro_torch.models.embed import (embed_tokens, embedding_init,
                                      head_logits, token_ids)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import torch_dtype
from repro_torch.utils.params import (compute_view, matrix_copies,
                                      with_compute_copies)

# a compute-dtype mirror of every per-layer matrix; the two layer stacks
# carry the stacked layer axis
compute_copies = partial(matrix_copies, stacked=("enc_layers", "dec_layers"))


def _attn_init(generator: torch.Generator, cfg: ModelConfig, n: int, *,
               device=None):
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads * hd, cfg.n_kv_heads * hd

    def dense(shape):
        return L.stacked_dense_init(generator, n, shape, device=device)

    return {"wq": dense((d, H)), "wk": dense((d, KV)), "wv": dense((d, KV)),
            "wo": dense((H, d))}


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``, with the compute-dtype copies made."""
    dev = resolve_device(device)
    d, ne, nd = cfg.d_model, cfg.n_enc_layers, cfg.n_layers
    enc = {"ln1": L.stacked_norm_init(ne, d, cfg.norm, device=dev),
           "attn": _attn_init(generator, cfg, ne, device=dev),
           "ln2": L.stacked_norm_init(ne, d, cfg.norm, device=dev),
           "mlp": T._mlp_init(generator, cfg, ne, device=dev)}
    dec = {"ln1": L.stacked_norm_init(nd, d, cfg.norm, device=dev),
           "self_attn": _attn_init(generator, cfg, nd, device=dev),
           "ln_x": L.stacked_norm_init(nd, d, cfg.norm, device=dev),
           "cross_attn": _attn_init(generator, cfg, nd, device=dev),
           "ln2": L.stacked_norm_init(nd, d, cfg.norm, device=dev),
           "mlp": T._mlp_init(generator, cfg, nd, device=dev)}
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        "enc_layers": enc,
        "ln_enc": L.norm_init(d, cfg.norm, device=dev),
        "dec_layers": dec,
        "ln_f": L.norm_init(d, cfg.norm, device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def _self_attn(x, ln, ap, cfg: ModelConfig, positions, *, causal: bool,
               window: int = 0):
    """Pre-norm self-attention over the whole sequence with its residual
    (no RoPE). Returns (x, (k, v))."""
    h = L.norm(x, ln, cfg.norm)
    q, k, v = L.gqa_project(h, ap, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                            positions, 0.0)
    a = T.attend(q, k, v, causal=causal, window=window)
    return x + L.matmul(a.flatten(-2), ap["wo"]), (k, v)


def _enc_layer_fwd(x, lp, cfg: ModelConfig, positions):
    x, _ = _self_attn(x, lp["ln1"], lp["attn"], cfg, positions, causal=False)
    return x + L.mlp(L.norm(x, lp["ln2"], cfg.norm), lp["mlp"], cfg.act)


def encode(params, frames, cfg: ModelConfig, *, remat: bool = False):
    """frames: (B, F, d) precomputed frame embeddings (the stub frontend)
    → the memory (B, F, d) in the compute dtype."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    dev = cw["ln_f"]["scale"].device
    x = torch.as_tensor(frames, device=dev).to(cd)
    F = x.shape[-2]
    x = x + L.sinusoidal_positions(F, cfg.d_model).to(dev, cd)
    positions = torch.arange(F, dtype=torch.int32, device=dev)
    layer = partial(_enc_layer_fwd, cfg=cfg, positions=positions)
    for lp in L.unstack_layers(cw["enc_layers"], int(L.is_chunk(cw))):
        x = L.remat_call(layer, x, lp, remat=remat)
    return L.norm(x, cw["ln_enc"], cfg.norm)


def _memory_kv(memory, lp, cfg: ModelConfig):
    """The memory's cross-attention K and V, each (B, F, KV, hd)."""
    return tuple(L.split_heads(L.matmul(memory, lp["cross_attn"][w]),
                               cfg.n_kv_heads, cfg.head_dim)
                 for w in ("wk", "wv"))


def _cross_attend(x, memory_kv, lp, cfg: ModelConfig, *, kernel: bool):
    """x: (B, Sq, d); memory_kv: (mk, mv) each (B, F, KV, hd).
    Bidirectional: `transformer.attend` when ``kernel`` (the whole-sequence
    path), else the plain attention (the decode step)."""
    mk, mv = memory_kv
    Sq = x.shape[-2]
    h = L.norm(x, lp["ln_x"], cfg.norm)
    q = L.split_heads(L.matmul(h, lp["cross_attn"]["wq"]), cfg.n_heads,
                      cfg.head_dim)
    if kernel:
        a = T.attend(q, mk, mv, causal=False)
    else:
        F = mk.shape[1]
        a = L.attention(q, mk, mv, causal=False,
                        q_positions=torch.zeros((Sq,), dtype=torch.int32,
                                                device=x.device),
                        kv_positions=torch.arange(F, dtype=torch.int32,
                                                  device=x.device))
    return x + L.matmul(a.flatten(-2), lp["cross_attn"]["wo"])


def _dec_layer_fwd(x, lp, memory, cfg: ModelConfig, positions, *,
                   window: int):
    """One decoder layer over the whole sequence → (x, (k, v, mk, mv))."""
    x, (k, v) = _self_attn(x, lp["ln1"], lp["self_attn"], cfg, positions,
                           causal=True, window=window)
    mkv = _memory_kv(memory, lp, cfg)
    x = _cross_attend(x, mkv, lp, cfg, kernel=True)
    x = x + L.mlp(L.norm(x, lp["ln2"], cfg.norm), lp["mlp"], cfg.act)
    return x, (k, v) + mkv


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    """batch: {frames (B, F, d), tokens (B, S)} → logits (B, S, Vpad)
    float32; with ``collect_cache`` also every decoder layer's (k, v, mk,
    mv), each stacked to (n_layers, B, ·, KV, hd). ``remat`` recomputes
    each encoder and decoder layer in the backward."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    memory = encode(params, batch["frames"], cfg, remat=remat)
    x = embed_tokens(cw["embed"], token_ids(cw, batch["tokens"]), cd)
    S = x.shape[-2]
    x = x + L.sinusoidal_positions(S, cfg.d_model).to(x.device, cd)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    layer = partial(_dec_layer_fwd, cfg=cfg, positions=positions,
                    window=cfg.attn_window)
    caches = []
    for lp in L.unstack_layers(cw["dec_layers"], int(L.is_chunk(cw))):
        x, kvs = L.remat_call(layer, x, lp, memory,
                              remat=remat and not collect_cache)
        if collect_cache:
            caches.append(kvs)
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)
    if not collect_cache:
        return logits
    return logits, tuple(torch.stack(c) for c in zip(*caches))


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True):
    logits = forward(params, batch, cfg, remat=remat)
    return L.lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    dev = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    kv = (cfg.n_layers, batch_size, T.cache_len(cfg, max_len),
          cfg.n_kv_heads, cfg.head_dim)
    xkv = (cfg.n_layers, batch_size, cfg.n_audio_frames, cfg.n_kv_heads,
           cfg.head_dim)
    return {"k": torch.zeros(kv, dtype=cd, device=dev),
            "v": torch.zeros(kv, dtype=cd, device=dev),
            "xk": torch.zeros(xkv, dtype=cd, device=dev),
            "xv": torch.zeros(xkv, dtype=cd, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    """Encode the frames and prefill the prompt → (last-position logits
    (B, Vpad), decode cache: ``max_len`` self KV slots per layer, or the
    ring, and the memory's K and V per layer)."""
    logits, (ks, vs, xks, xvs) = forward(params, batch, cfg,
                                         collect_cache=True)
    cache = T.prefill_cache(ks, vs, batch["tokens"], cfg, max_len)
    cache.update(xk=xks, xv=xvs)
    return logits[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """One token (B,) for every row at the cache's position ``pos`` →
    (logits (B, Vpad), cache). Writes into ``cache["k"]`` and
    ``cache["v"]`` in place."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    pos = cache["pos"]
    x = embed_tokens(cw["embed"], token_ids(cw, tokens)[:, None], cd)
    x = x + L.sinusoidal_position_at(pos, cfg.d_model).to(cd)[None]
    slot, kv_positions = T.decode_slots(cfg, pos, cache["k"].shape[2])
    no_rope = cfg.with_(rope_theta=0.0)
    for i, lp in enumerate(L.unstack_layers(cw["dec_layers"])):
        x = T._attn_step(x, {"ln1": lp["ln1"], "attn": lp["self_attn"]},
                         no_rope, cache["k"][i],
                         cache["v"][i], pos, slot, kv_positions)
        x = _cross_attend(x, (cache["xk"][i], cache["xv"][i]), lp, cfg,
                          kernel=False)
        x = x + L.mlp(L.norm(x, lp["ln2"], cfg.norm), lp["mlp"], cfg.act)
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)[:, 0, :]
    return logits, {"k": cache["k"], "v": cache["v"], "xk": cache["xk"],
                    "xv": cache["xv"], "pos": pos + 1}


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
