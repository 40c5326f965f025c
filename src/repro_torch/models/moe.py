"""Mixture-of-Experts decoder (olmoe-1b-7b, granite-moe-3b-a800m): the port
of ``repro.models.moe``.

GShard/Switch-style dense dispatch: top-k routing with a capacity per
expert, one-hot dispatch and combine products, and the Switch load-balance
aux loss. The attention blocks are the dense family's
(`repro_torch.models.transformer`): flash attention once per layer in the
prefill for CUDA tensors. The dispatch, expert and combine products are
plain `torch.einsum` calls, as the reference computes them outside any
Pallas kernel.

Numerics, as the reference's:

- the router runs in float32 (``x.float() @ w.float()``), so its compute
  copy stays the float32 parameter (`compute_copies`);
- the top-k order among equal probabilities is ``lax.top_k``'s (the lower
  expert first; `_top_k`);
- ``combine`` is rounded to bfloat16 whatever the compute dtype, and
  ``dispatch = combine > 0`` is taken after that rounding, so a weight that
  rounds to 0 drops its token.

Tokens are routed in groups of ``MOE_GROUP`` (the last zero-padded). The
inference path (``dropless=True``: the prefill and the decode step) gives
capacity = the group only for groups of at most 128 tokens; a larger group
(a 4 × 512 prefill) routes at ``_capacity(group, E, k, 1.5)`` and can drop
pairs that a decode step keeps.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.api import Model
from repro_torch.models.embed import (embed_tokens, embedding_init,
                                      head_logits, token_ids)
from repro_torch.sharding.kernel_map import is_dtensor, map_local
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import (client_apply, client_einsum,
                                        compute_einsum, torch_dtype)
from repro_torch.utils.params import compute_view, with_compute_copies

AUX_LOSS_COEF = 0.01
CAPACITY_FACTOR = 1.25
INFERENCE_CAPACITY_FACTOR = 1.5
MOE_GROUP = 512  # GShard-style local routing groups


def _capacity(n_tokens: int, n_experts: int, top_k: int,
              factor: float = CAPACITY_FACTOR) -> int:
    c = int(n_tokens * top_k * factor / n_experts) + 1
    return max(4, min(n_tokens, ((c + 15) // 16) * 16))


def compute_copies(params, cd: torch.dtype):
    """The dense family's copies, but the router keeps its float32 weight:
    the reference routes in float32 whatever the compute dtype."""
    out = T.compute_copies(params, cd)
    out["layers"]["moe"]["router"] = params["layers"]["moe"]["router"]
    return out


def moe_layers_init(generator: torch.Generator, cfg: ModelConfig, n: int, *,
                    device=None):
    """Router and experts of ``n`` stacked layers: router ``w`` (n, d, E),
    ``w_gate`` and ``w_up`` (n, E, d, f), ``w_down`` (n, E, f, d)."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff

    def dense(shape, in_dim):
        return L.stacked_dense_init(generator, n, shape, in_dim,
                                    device=device)

    return {"router": {"w": dense((d, E), d)},
            "w_gate": dense((E, d, f), d), "w_up": dense((E, d, f), d),
            "w_down": dense((E, f, d), f)}


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``, with the compute-dtype copies made."""
    dev = resolve_device(device)
    layers = T.attn_layers_init(generator, cfg, cfg.n_layers, device=dev)
    layers["moe"] = moe_layers_init(generator, cfg, cfg.n_layers, device=dev)
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        "layers": layers,
        "ln_f": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, in descending
    order, the lower index first among equal values (a stable sort;
    `torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(x, p, cfg: ModelConfig, capacity: int = None):
    """x: (..., T, d), each leading index one routing group → combine
    (..., T, E, C) float32 and the aux load-balance loss (...) float32. A
    router with a leading client axis (C, d, E) routes a chunk of clients,
    x (C, ..., T, d), each client's groups against its own router: every
    step after the router's product is per group, so a client's top-k
    sets, places and dropped pairs are those of its one-client call."""
    T_ = x.shape[-2]
    E, k = cfg.n_experts, cfg.top_k
    C = capacity or _capacity(T_, E, k)
    logits = L.matmul(x.float(), p["router"]["w"].float())
    probs = torch.softmax(logits, dim=-1)                      # (..., T, E)
    topv, topi = _top_k(probs, k)                              # (..., T, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # each pair's place in its expert: the reference counts the pairs of
    # slot 0 token by token, then those of slot 1 after them, and so on (a
    # cumsum per slot plus the running fill). In that slot-major order, a
    # pair's place is its rank among the pairs of its expert: a stable sort
    # by expert gives the same integers. Pairs at C or past it are dropped
    # (their weight adds 0 at place 0)
    lead = x.shape[:-2]
    e = topi.transpose(-1, -2).reshape(lead + (k * T_,))
    srt, order = torch.sort(e, dim=-1, stable=True)
    counts = torch.zeros(lead + (E,), dtype=torch.long, device=x.device)
    counts.scatter_add_(-1, e, torch.ones_like(e))
    starts = torch.cumsum(counts, dim=-1) - counts
    rank = torch.arange(k * T_, device=x.device) - starts.gather(-1, srt)
    place = torch.empty_like(e).scatter_(-1, order, rank)
    place = place.reshape(lead + (k, T_)).transpose(-1, -2)    # (..., T, k)
    # Switch aux loss: E · Σ_e f_e · P_e (f = token fraction, P = mean prob)
    frac = counts.float() / T_                                 # (..., E)
    aux = E * torch.sum(frac * probs.mean(-2), dim=-1) / k
    keep = place < C
    where = topi * C + torch.where(keep, place, 0)
    combine = torch.zeros(lead + (T_, E * C), dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(-1, where, topv * keep.float())
    return combine.reshape(x.shape[:-2] + (T_, E, C)), aux


def moe_ffn(x, p, cfg: ModelConfig, *, dropless: bool = False):
    """x: (B, S, d) → (B, S, d) and the aux loss (the mean over groups).
    A chunk of clients, x (C, B, S, d) with a client axis leading the
    router and the experts ((C, E, d, f)), routes each client's tokens in
    its own groups (`route`) and runs each client's experts
    (`numerics.client_einsum`) → (C, B, S, d) and the aux losses (C,)."""
    chunk = p["w_gate"].dim() == 4
    lead = tuple(x.shape[:1]) if chunk else ()
    B, S, d = x.shape[-3:]
    cd = x.dtype
    n = B * S
    group = min(MOE_GROUP, n)
    pad = (-n) % group
    xf = x.reshape(lead + (n, d))
    if pad:
        xf = torch.cat([xf, xf.new_zeros(lead + (pad, d))], dim=-2)
    xg = xf.reshape(lead + (-1, group, d))
    cap = None
    if dropless:
        cap = group if group <= 128 else _capacity(
            group, cfg.n_experts, cfg.top_k, INFERENCE_CAPACITY_FACTOR)
    if is_dtensor(xg):
        # DTensor has no rule for route's in-place scatter_add_ into its
        # plain count tensor: the replicated rows are routed locally
        combine, aux = map_local(
            lambda x, w: route(x, {"router": {"w": w}}, cfg, capacity=cap),
            (xg, p["router"]["w"]), (None, None), (None, None), shard=False)
    else:
        combine, aux = route(xg, p, cfg, capacity=cap)
    # under the production step's mesh: dispatch and combine group-sharded
    # over the batch axes and expert-sharded where E divides (no-ops off it)
    combine = L.shard_hint(combine.to(torch.bfloat16),
                           ("pod", "data"), None, "model", None)
    dispatch = (combine > 0).to(cd)                            # (G,t,E,C)
    ein = client_einsum if chunk else compute_einsum
    xe = ein("gtec,gtd->gecd", dispatch, xg)
    xe = L.shard_hint(xe, ("pod", "data"), "model", None, None)
    gate = client_apply(F.silu, ein("gecd,edf->gecf", xe, p["w_gate"]),
                        chunk)
    up = ein("gecd,edf->gecf", xe, p["w_up"])
    h = ein("gecf,efd->gecd", gate * up, p["w_down"])
    h = L.shard_hint(h, ("pod", "data"), "model", None, None)
    y = ein("gtec,gecd->gtd", combine.to(cd), h).reshape(lead + (-1, d))
    return y[..., :n, :].reshape(x.shape), aux.mean(-1)


def _layer_fwd(x, lp, cfg: ModelConfig, positions, *, dropless: bool):
    """One MoE layer: (x, lp) → (x, (k, v), aux)."""
    x, kv = T._attn_block(x, lp, cfg, positions, window=cfg.attn_window)
    h = L.norm(x, lp["ln2"], cfg.norm)
    y, aux = moe_ffn(h, lp["moe"], cfg, dropless=dropless)
    return x + y, kv, aux


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False, with_aux: bool = False,
            dropless: bool = False):
    """Logits (B, S, Vpad) float32; ``with_aux`` adds the aux loss (the mean
    over layers); ``collect_cache`` returns (logits, (ks, vs), aux).
    ``remat`` recomputes each layer in the backward."""
    cw = compute_view(params)
    x = T._embed_batch(cw, batch, cfg)
    positions = torch.arange(x.shape[-2], dtype=torch.int32,
                             device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    layer = partial(_layer_fwd, cfg=cfg, positions=positions,
                    dropless=dropless)
    kvs = []
    for lp in L.unstack_layers(cw["layers"], int(L.is_chunk(cw))):
        x, kv, aux = L.remat_call(layer, x, lp, remat=remat)
        aux_total = aux_total + aux
        if collect_cache:
            kvs.append(kv)
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)
    aux_total = aux_total / cfg.n_layers
    if collect_cache:
        return logits, (torch.stack([k for k, _ in kvs]),
                        torch.stack([v for _, v in kvs])), aux_total
    return (logits, aux_total) if with_aux else logits


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True):
    logits, aux = forward(params, batch, cfg, remat=remat, with_aux=True)
    nll = L.lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))
    return nll + AUX_LOSS_COEF * aux


def loss_fn_clients(params_c, batch_c, cfg: ModelConfig, *,
                    remat: bool = True):
    """The losses (C,) of a chunk of clients, each with its own parameters
    (leading client axis C, batch leaves (C, B, S)): client c's is
    `loss_fn`'s, its aux loss from its own routing, the same bits whatever
    C is."""
    logits, aux = forward(params_c, batch_c, cfg, remat=remat,
                          with_aux=True)
    nll = L.lm_loss_clients(logits, batch_c["labels"], cfg.vocab,
                            batch_c.get("mask"))
    return nll + AUX_LOSS_COEF * aux


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    """Prompt prefill on the inference path (``dropless``) → (last-position
    logits (B, Vpad), decode cache)."""
    logits, (ks, vs), _ = forward(params, batch, cfg, collect_cache=True,
                                  dropless=True)
    return logits[:, -1, :], T.prefill_cache(ks, vs, batch["tokens"], cfg,
                                             max_len)


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """One token (B,) for every row at the cache's position ``pos``, every
    group routed dropless. Writes into ``cache["k"]`` and ``cache["v"]`` in
    place."""
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_view(params)
    pos = cache["pos"]
    x = embed_tokens(cw["embed"], token_ids(cw, tokens)[:, None], cd)
    slot, kv_positions = T.decode_slots(cfg, pos, cache["k"].shape[2])
    for i, lp in enumerate(L.unstack_layers(cw["layers"])):
        x = T._attn_step(x, lp, cfg, cache["k"][i], cache["v"][i], pos, slot,
                         kv_positions)
        h = L.norm(x, lp["ln2"], cfg.norm)
        y, _ = moe_ffn(h, lp["moe"], cfg, dropless=True)
        x = x + y
    x = L.norm(x, cw["ln_f"], cfg.norm)
    logits = head_logits(cw["embed"], x)[:, 0, :]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=partial(init, cfg=cfg),
        forward=partial(forward, cfg=cfg),
        loss_fn=partial(loss_fn, cfg=cfg),
        init_cache=partial(T.init_cache, cfg),
        prefill=partial(prefill, cfg=cfg),
        decode_step=partial(decode_step, cfg=cfg),
        compute_copies=compute_copies,
        client_loss_fn=partial(loss_fn_clients, cfg=cfg),
    )
