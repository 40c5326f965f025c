"""Zamba2-style hybrid [arXiv:2411.15242]: a Mamba-2 backbone with a single
*shared* GQA attention + MLP block applied after every ``hybrid_attn_every``
Mamba layers (weights shared across sites, a KV cache per site).

The port of ``repro.models.hybrid``, on the same stacked parameter tree
(``mamba_layers`` leaves carry a leading ``(n_layers, …)`` axis). The
prefill runs two hand-written CUDA kernels on the card: the SSD scan in
every Mamba-2 mixer (`repro_torch.models.mamba2.mixer_fwd`) and causal flash
attention at every shared-attention site (the dense block,
`repro_torch.models.transformer._layer_fwd`); on the CPU
both are their plain PyTorch versions. The decode step's attention over the
cache (one query, ``kv_len = pos + 1``) is the plain `layers.attention` on
every device, as in the reference, which has no kernel for it either.

Numerics: the reference's plain attention rounds its probabilities to the
compute dtype before the PV product. The flash kernel does the same for
bfloat16 inputs (its tensor-core form rounds the unnormalised P to bf16
before PV and divides by the float32 row sum once, where the TPU kernel
keeps P in float32), and keeps P in float32 for float32 inputs. In bfloat16
the card's prefill therefore differs from the reference by the order of its
sums and where it rounds; in float32 the two agree.

The decode step writes the new token's K and V into the cache's ``k`` and
``v`` in place (the reference returns updated copies): the returned cache
holds the same two tensors.

Training: ``loss_fn`` recomputes each group (its Mamba-2 layers and the
shared block after them) in the backward (``remat``, on by default as in
the reference); both kernels' outputs are differentiable through their
plain versions' gradients (`repro_torch.kernels.recompute`), and the
shared block's gradient sums every site's. A chunk of clients trains as
one program (`layers.chunk_loss`): each client has its own shared block,
applied at every site to that client's rows alone.
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.api import Model
from repro_torch.models.embed import (embed_tokens, embedding_init,
                                      head_logits, token_ids)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import torch_dtype
from repro_torch.utils.params import (compute_view, matrix_copies,
                                      with_compute_copies)


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


def _groups(params, cfg: ModelConfig):
    """Per attention site, the list of its ``hybrid_attn_every`` Mamba
    layers' parameters (views), in order."""
    layers = L.unstack_layers(params["mamba_layers"],
                              int(L.is_chunk(params)))
    e = cfg.hybrid_attn_every
    return [layers[g * e:(g + 1) * e] for g in range(n_attn_sites(cfg))]


def _group_fwd(x, group, sp, cfg: ModelConfig, positions):
    """One site's Mamba-2 layers, then the shared block: → (x, (the
    mixers' (final SSD state, conv tails), the site's (k, v)))."""
    mcaches = []
    for lp in group:
        x, mc = M.layer_fwd(x, lp, cfg)
        mcaches.append(mc)
    x, kv = T._layer_fwd(x, sp, cfg, positions, window=cfg.attn_window)
    return x, (mcaches, kv)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    """Logits (B, S, Vpad) float32; with ``collect_cache`` also every
    mixer's (final SSD state, conv tails) and every site's (k, v).
    ``remat`` recomputes each group (its Mamba-2 layers and the shared
    block after them) in the backward, as the reference's checkpoint of
    its group body."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    x = embed_tokens(cw["embed"], token_ids(cw, batch["tokens"]), cd)
    positions = torch.arange(x.shape[-2], dtype=torch.int32,
                             device=x.device)
    group_fwd = partial(_group_fwd, cfg=cfg, positions=positions)
    sp = cw["shared_attn"]
    mcaches, kvs = [], []
    for group in _groups(cw, cfg):
        x, (mc, kv) = L.remat_call(group_fwd, x, group, sp,
                                   remat=remat and not collect_cache)
        if collect_cache:
            mcaches.extend(mc)
            kvs.append(kv)
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    logits = head_logits(cw["embed"], x)
    return (logits, (mcaches, kvs)) if collect_cache else logits


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True):
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
    cache["k"] = T._pad_kv(torch.stack([k for k, _ in kvs]), max_len)
    cache["v"] = T._pad_kv(torch.stack([v for _, v in kvs]), max_len)
    cache["pos"] = torch.tensor(logits.shape[1], dtype=torch.int32,
                                device=logits.device)
    return logits[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """One token for every row at the cache's position ``pos``. Writes the
    token's K and V into ``cache["k"]`` and ``cache["v"]`` in place."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    pos = cache["pos"]
    x = embed_tokens(cw["embed"], token_ids(cw, tokens)[:, None], cd)
    sp = cw["shared_attn"]
    max_len = cache["k"].shape[2]
    kv_positions = torch.arange(max_len, dtype=torch.int32, device=x.device)
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
        x = T._attn_step(x, sp, cfg, cache["k"][site], cache["v"][site], pos,
                         slot, kv_positions)
        h2 = L.norm(x, sp["ln2"], cfg.norm)
        x = x + L.mlp(h2, sp["mlp"], cfg.act)
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    logits = head_logits(cw["embed"], x)[:, 0, :]
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
        client_loss_fn=partial(L.chunk_loss, forward, cfg=cfg),
    )
