"""Zamba2-style hybrid [arXiv:2411.15242]: a Mamba-2 backbone with a single
*shared* GQA attention + MLP block applied after every ``hybrid_attn_every``
Mamba layers (weights shared across sites, a KV cache per site).

The port of ``repro.models.hybrid``, on the same stacked parameter tree
(``mamba_layers`` leaves carry a leading ``(n_layers, …)`` axis). The
prefill runs two hand-written CUDA kernels on the card: the SSD scan in
every Mamba-2 mixer (`repro_torch.models.mamba2.mixer_fwd`) and causal flash
attention at every shared-attention site (`_shared_attn_fwd`); on the CPU
both are their plain PyTorch versions. The decode step's attention over the
cache (one query, ``kv_len = pos + 1``) is the plain `layers.attention` on
every device, as in the reference, which has no kernel for it either.

Numerics: the reference's plain attention rounds its probabilities to the
compute dtype before the PV product; the flash kernel keeps them in float32,
as the TPU kernel does. In bfloat16 the card's prefill therefore differs
from the reference by rounding; in float32 the two agree.

The decode step writes the new token's K and V into the cache's ``k`` and
``v`` in place (the reference returns updated copies): the returned cache
holds the same two tensors.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.api import Model
from repro_torch.models.embed import embed_tokens, embedding_init
from repro_torch.models.transformer import _pad_kv
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import torch_dtype
from repro_torch.utils.params import matrix_copies, with_compute_copies


def n_attn_sites(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.hybrid_attn_every:
        raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                         f"hybrid_attn_every {cfg.hybrid_attn_every}")
    return cfg.n_layers // cfg.hybrid_attn_every


# a compute-dtype mirror of every per-layer matrix, the shared block's
# included; "mamba_layers" leaves carry the stacked layer axis
compute_copies = partial(matrix_copies, stacked=("mamba_layers",))


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``, with the compute-dtype copies made."""
    dev = resolve_device(device)
    n_attn_sites(cfg)
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        "mamba_layers": M.layers_init(generator, cfg, cfg.n_layers,
                                      device=dev),
        "shared_attn": {
            "ln1": L.norm_init(cfg.d_model, cfg.norm, device=dev),
            "attn": L.gqa_init(generator, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim, device=dev),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, device=dev),
            "mlp": L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act,
                              device=dev),
        },
        "ln_f": L.norm_init(cfg.d_model, "rmsnorm", device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def _group_params(params, cfg: ModelConfig):
    """The stacked (n_layers, …) Mamba parameters as (sites, every, …)
    views."""
    g, e = n_attn_sites(cfg), cfg.hybrid_attn_every

    def regroup(t):
        if isinstance(t, dict):
            return {k: regroup(v) for k, v in t.items()}
        return t.reshape((g, e) + tuple(t.shape[1:]))
    return regroup(params["mamba_layers"])


def _groups(params, cfg: ModelConfig):
    """Per attention site, the list of its ``hybrid_attn_every`` Mamba
    layers' parameters (views), in order."""
    grouped = _group_params(params, cfg)
    return [[M.layer_params(M.layer_params(grouped, g), j)
             for j in range(cfg.hybrid_attn_every)]
            for g in range(n_attn_sites(cfg))]


def _shared_attn_fwd(x, sp, cfg: ModelConfig, positions, *, window):
    """The shared block over a whole sequence (positions 0..S-1): causal
    attention through the flash kernel for CUDA tensors, the plain
    `layers.attention` on the CPU. Returns (x, (k, v))."""
    h = L.norm(x, sp["ln1"], cfg.norm)
    q, k, v = L.gqa_project(h, sp["attn"], cfg.n_heads, cfg.n_kv_heads,
                            cfg.head_dim, positions, cfg.rope_theta)
    if x.device.type == "cuda":
        a = flash_attention(q, k, v, causal=True, window=window)
    else:
        a = L.attention(q, k, v, q_positions=positions,
                        kv_positions=positions, causal=True, window=window)
    B, S = a.shape[:2]
    x = x + L.matmul(a.reshape(B, S, -1), sp["attn"]["wo"])
    h2 = L.norm(x, sp["ln2"], cfg.norm)
    x = x + L.mlp(h2, sp["mlp"], cfg.act)
    return x, (k, v)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    del remat   # the port runs no training of this family yet
    cd = torch_dtype(cfg.compute_dtype)
    cw = M._weights(params)
    tokens = M._tokens(params, batch["tokens"])
    x = embed_tokens(cw["embed"], tokens, cd)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    sp = cw["shared_attn"]
    mcaches, kvs = [], []
    for group in _groups(cw, cfg):
        for lp in group:
            h = L.norm(x, lp["ln"], "rmsnorm")
            if collect_cache:
                out, h_fin, tails = M.mixer_fwd(h, lp["mixer"], cfg,
                                                return_state=True)
                mcaches.append((h_fin, tails))
            else:
                out = M.mixer_fwd(h, lp["mixer"], cfg)
            x = x + out
        x, kv = _shared_attn_fwd(x, sp, cfg, positions,
                                 window=cfg.attn_window)
        if collect_cache:
            kvs.append(kv)
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    logits = M.logits(cw, x)
    return (logits, (mcaches, kvs)) if collect_cache else logits


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    logits = forward(params, batch, cfg, remat=remat)
    return L.lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    dev = resolve_device(device)
    cache = M.init_cache(cfg, batch_size, max_len, device=dev)
    kv = (n_attn_sites(cfg), batch_size, max_len, cfg.n_kv_heads,
          cfg.head_dim)
    cd = torch_dtype(cfg.compute_dtype)
    cache["k"] = torch.zeros(kv, dtype=cd, device=dev)
    cache["v"] = torch.zeros(kv, dtype=cd, device=dev)
    return cache


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    """Prompt prefill → (last-position logits (B, Vpad), decode cache with
    ``max_len`` KV slots per site)."""
    logits, (mcaches, kvs) = forward(params, batch, cfg, collect_cache=True)
    cache = M.stack_caches(mcaches, torch_dtype(cfg.compute_dtype))
    cache["k"] = _pad_kv(torch.stack([k for k, _ in kvs]), max_len)
    cache["v"] = _pad_kv(torch.stack([v for _, v in kvs]), max_len)
    cache["pos"] = torch.tensor(logits.shape[1], dtype=torch.int32,
                                device=logits.device)
    return logits[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """One token for every row at the cache's position ``pos``. Writes the
    token's K and V into ``cache["k"]`` and ``cache["v"]`` in place."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = M._weights(params)
    pos = cache["pos"]
    x = embed_tokens(cw["embed"], M._tokens(params, tokens)[:, None], cd)
    sp = cw["shared_attn"]
    max_len = cache["k"].shape[2]
    kv_positions = torch.arange(max_len, dtype=torch.int32, device=x.device)
    q_positions = pos.reshape(1)
    # the reference's dynamic_update_slice clamps its start index
    slot = pos.reshape(1).long().clamp(max=max_len - 1)
    new = {"ssm": [], "conv_x": [], "conv_B": [], "conv_C": []}
    i = 0
    for site, group in enumerate(_groups(cw, cfg)):
        for lp in group:
            hin = L.norm(x, lp["ln"], "rmsnorm")
            out, h_new, conv = M.mixer_step(
                hin, lp["mixer"], cfg, cache["ssm"][i],
                (cache["conv_x"][i], cache["conv_B"][i], cache["conv_C"][i]))
            x = x + out
            new["ssm"].append(h_new)
            for k, c in zip(("conv_x", "conv_B", "conv_C"), conv):
                new[k].append(c)
            i += 1
        h = L.norm(x, sp["ln1"], cfg.norm)
        q, k, v = L.gqa_project(h, sp["attn"], cfg.n_heads, cfg.n_kv_heads,
                                cfg.head_dim, q_positions, cfg.rope_theta)
        kc, vc = cache["k"][site], cache["v"][site]
        kc.index_copy_(1, slot, k.to(kc.dtype))
        vc.index_copy_(1, slot, v.to(vc.dtype))
        a = L.attention(q, kc, vc, q_positions=q_positions,
                        kv_positions=kv_positions, kv_len=pos + 1,
                        causal=True, window=cfg.attn_window)
        x = x + L.matmul(a.reshape(x.shape[0], 1, -1), sp["attn"]["wo"])
        h2 = L.norm(x, sp["ln2"], cfg.norm)
        x = x + L.mlp(h2, sp["mlp"], cfg.act)
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    logits = M.logits(cw, x)[:, 0, :]
    new = {k: torch.stack(v) for k, v in new.items()}
    new.update(k=cache["k"], v=cache["v"], pos=pos + 1)
    return logits, new


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
    )
