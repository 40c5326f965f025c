"""UserUpdate(k, θ) — Algorithm 1's client procedure — and the cohort
accumulation (the reference's ``fl/client.py``).

E local epochs of minibatch SGD at learning rate η_c, then the model delta
Δ = θ_local − θ0, clipped to L2 norm S and folded into the round sum.

:func:`round_compute` is the host trainer's round body. It accumulates the
round's clipped sum by streaming: the padded cohort is cut into the
canonical blocks of `repro_torch.fl.reduction`, each block is taken
``cohort_chunk`` clients at a time, and each client's clipped update is
folded into the block's partial one slot at a time, left to right
(:func:`chunk_accumulate`: on the default ``clip_path="fused"`` the CUDA
dp_clip kernels, one sum-of-squares launch and one accumulate launch per
leaf for the whole chunk, through
`core.clipping.clip_accumulate_chunk_tree`). Peak update memory is
O(cohort_chunk · |params|), and the sum is bit-identical for every
``cohort_chunk`` dividing the block size. ``cohort_chunk=0`` selects the
materializing path, kept as the reference.

A chunk of clients trains as one batched program, every family of the zoo
through its ``client_loss_fn``: the chunk's parameters are θ0 expanded to a
leading client axis, and each local SGD step is one forward of the
per-client losses and one ``autograd.grad`` of their sum — no client's loss
reads another client's parameters, so client c's gradient is exactly
∂L_c/∂θ_c. This is the reference's ``vmap`` of :func:`local_delta` over
the chunk: each kernel launches once per layer for the whole chunk (the
CIFG cell kernels with a client axis, flash attention and the SSD scan with
the clients folded into their batch). A client's delta and loss are the
same bits whatever the chunk's width and wherever the client sits
(`utils.numerics`: each client's products are calls of their own with its
own weights, and the attention and SSD gradients run a client at a time),
and :func:`local_delta` and :func:`user_update` are the same program at a
width of 1. A chunk that does not fit the card
fails with CUDA's out-of-memory error; nothing retries it client by
client. A model built with ``client_loss_fn=None`` trains the chunk's
clients one after another through ``loss_fn``.

Trees are nested dicts of tensors; client batches are dicts of tensors with
leading axes (n_batches, B, S), stacked per cohort as (C, n_batches, B, S).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ClientConfig, DPConfig
from repro_torch.core.clipping import (clip_accumulate_chunk_tree,
                                       clip_accumulate_tree,
                                       clip_by_global_norm)
from repro_torch.fl.reduction import (CANON_BLOCKS, canon_pad, fold_blocks,
                                      resolve_chunk)
from repro_torch.models.api import Model
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_sub,
                                      tree_unflatten, tree_zeros_like)
from repro_torch.utils.spans import count, span


def _index(tree, i):
    return tree_map(lambda l: l[i], tree)


def _stack(trees: List) -> Dict:
    return tree_map(lambda *ls: torch.stack(ls), *trees)


def _mean(xs: List[torch.Tensor]) -> torch.Tensor:
    """The mean of equally shaped tensors as one sum left to right, so each
    element's bits depend only on its own values."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x
    return total / len(xs)


def _local_sgd_clients(model: Model, params0, chunk_batches,
                       client: ClientConfig):
    """E epochs of SGD for every client of a chunk as one batched program:
    ``params0`` one tree, ``chunk_batches`` (C, n_batches, B, S) tensors →
    (local params, every leaf with a leading C axis; mean losses (C,)).
    Each step is one ``client_loss_fn`` and one ``autograd.grad`` of the
    losses' sum; the update is applied in the parameters' dtype."""
    C, n_batches = tree_leaves(chunk_batches)[0].shape[:2]
    params0 = strip_compute(params0)
    flat = [l.detach().expand((C,) + tuple(l.shape))
            for l in tree_leaves(params0)]
    epoch_losses = []
    for _ in range(client.local_epochs):
        losses = []
        for i in range(n_batches):
            with span("client.grad"):
                leaves = [l.detach().requires_grad_(True) for l in flat]
                loss = model.client_loss_fn(
                    tree_unflatten(params0, leaves),
                    tree_map(lambda l: l[:, i], chunk_batches))
                grads = list(torch.autograd.grad(loss.sum(), leaves))
                del leaves
            # leaf by leaf, each gradient and old leaf dropped as soon as
            # its update is made: a full-width chunk holds C copies of the
            # model in each of them
            with span("client.update"), torch.no_grad():
                for j, w in enumerate(flat):
                    g, grads[j] = grads[j], None
                    flat[j] = (w.float() - client.lr * g.float()).to(w.dtype)
                    del w, g
            losses.append(loss.detach())
        epoch_losses.append(_mean(losses))
    return tree_unflatten(params0, flat), _mean(epoch_losses)


def local_sgd(model: Model, params, batches: Dict[str, torch.Tensor],
              client: ClientConfig):
    """E epochs of SGD over ``batches`` ((n_batches, B, S) tensors) →
    (local params, mean loss). The compute copies of ``params``, if any,
    are dropped: every step casts the updated weights afresh. A model with
    ``client_loss_fn`` runs the chunk program at a width of 1."""
    if model.client_loss_fn is not None:
        p, loss = _local_sgd_clients(
            model, params, tree_map(lambda l: l[None], batches), client)
        return tree_map(lambda l: l[0], p), loss[0]
    p = tree_map(torch.Tensor.detach, strip_compute(params))
    n_batches = tree_leaves(batches)[0].shape[0]
    epoch_losses = []
    for _ in range(client.local_epochs):
        losses = []
        for i in range(n_batches):
            with span("client.grad"):
                q = tree_map(lambda l: l.detach().requires_grad_(True), p)
                loss = model.loss_fn(q, _index(batches, i))
                grads = tree_unflatten(q, torch.autograd.grad(
                    loss, tree_leaves(q)))
            with span("client.update"), torch.no_grad():
                p = tree_map(lambda w, g: (w.float() - client.lr * g.float())
                             .to(w.dtype), q, grads)
            losses.append(loss.detach())
        epoch_losses.append(torch.stack(losses).mean())
    return p, torch.stack(epoch_losses).mean()


def local_delta(model: Model, params0, batches, client: ClientConfig):
    """Unclipped client delta: E local epochs, then Δ = θ_local − θ0 in
    float32. Returns (delta tree, mean loss). A model with
    ``client_loss_fn`` runs :func:`local_deltas` at a width of 1."""
    if model.client_loss_fn is not None:
        deltas, losses = local_deltas(
            model, params0, tree_map(lambda l: l[None], batches), client)
        return deltas[0], losses[0]
    params0 = strip_compute(params0)
    params_local, loss = local_sgd(model, params0, batches, client)
    f32 = lambda t: tree_map(lambda l: l.detach().float(), t)  # noqa: E731
    return tree_sub(f32(params_local), f32(params0)), loss


def local_deltas(model: Model, params, chunk_batches, client: ClientConfig
                 ) -> Tuple[List, torch.Tensor]:
    """:func:`local_delta` of each client of a chunk (leading axis of
    ``chunk_batches``) → (list of delta trees, losses (chunk,)). With the
    model's ``client_loss_fn`` (every family's) the chunk is one batched
    program and the delta trees are views of one (chunk, …) stack a leaf;
    a model built with ``client_loss_fn=None`` runs the clients one after
    another."""
    with span("client.step"):
        if model.client_loss_fn is None:
            n = tree_leaves(chunk_batches)[0].shape[0]
            out = [local_delta(model, params, _index(chunk_batches, i),
                               client) for i in range(n)]
            return [d for d, _ in out], torch.stack([l for _, l in out])
        params0 = strip_compute(params)
        local, losses = _local_sgd_clients(model, params0, chunk_batches,
                                           client)
        # in place: the local parameters are this call's own
        delta = tree_map(lambda a, b: a.float().sub_(b.detach().float()),
                         local, params0)
        del local
        leaves = [l.unbind(0) for l in tree_leaves(delta)]
        return ([tree_unflatten(delta, list(ls)) for ls in zip(*leaves)],
                losses)


def user_update(model: Model, params0, batches, client: ClientConfig,
                dp: DPConfig):
    """Returns (clipped Δ_k, pre-clip norm, was_clipped, mean loss)."""
    delta, loss = local_delta(model, params0, batches, client)
    clipped, norm, was_clipped = clip_by_global_norm(delta, dp.clip_norm)
    return clipped, norm, was_clipped, loss


def client_updates(model: Model, params, stacked_batches,
                   client: ClientConfig, dp: DPConfig):
    """:func:`user_update` for every client of the stacked cohort,
    unreduced: (list of clipped Δ, norms (C,), was_clipped (C,), losses
    (C,)). The materializing path (O(cohort) update memory)."""
    n = tree_leaves(stacked_batches)[0].shape[0]
    out = [user_update(model, params, _index(stacked_batches, i), client, dp)
           for i in range(n)]
    clipped, norms, flags, losses = zip(*out)
    return (list(clipped), torch.stack(norms), torch.stack(flags),
            torch.stack(losses))


# ------------------------------------------------------- streaming fold


def chunk_accumulate(acc, deltas: List, losses, mask, clip_norm: float, *,
                     clip_path: str = "fused",
                     guard_nonfinite: bool = False):
    """Fold one chunk's unclipped client deltas into the running block
    accumulator, one slot at a time, left to right.

    ``acc`` is ``(update tree f32, stats (4,) f32)``, the stats packing
    [Σ norms, Σ clipped flags, Σ losses, Σ mask]. ``mask`` is the chunk's
    0/1 slot mask, folded into the clip factor, so a masked slot adds
    exactly ±0. ``guard_nonfinite`` rejects a slot whose delta or loss holds
    a non-finite value before it reaches the sum: its values are zeroed
    (NaN·0 is NaN, so zeroing the mask alone would not do) and its mask
    becomes 0. On ``clip_path="fused"`` every slot's factor is computed
    first and the chunk is folded with one accumulate launch per leaf; the
    bits are those of one `clip_accumulate_tree` per slot."""
    with span("clip.accumulate"):
        upd, stats = acc
        m = mask.float()
        slots = []
        for i, delta in enumerate(deltas):
            loss, mi = losses[i], m[i]
            if guard_nonfinite:
                ok = torch.stack([torch.isfinite(l).all()
                                  for l in tree_leaves(delta)]
                                 + [torch.isfinite(loss)]).all().float()
                delta = tree_map(
                    lambda l: torch.where(torch.isfinite(l), l, 0.0), delta)
                loss = torch.where(torch.isfinite(loss), loss, 0.0)
                mi = mi * ok
            slots.append((delta, loss, mi))
        if clip_path == "fused" and slots:
            upd, norms, flags = clip_accumulate_chunk_tree(
                upd, [d for d, _, _ in slots], clip_norm,
                [mi for _, _, mi in slots])
        else:
            norms, flags = [], []
            for delta, _, mi in slots:
                upd, norm, flag = clip_accumulate_tree(upd, delta, clip_norm,
                                                       scale=mi,
                                                       clip_path=clip_path)
                norms.append(norm)
                flags.append(flag)
        for (_, loss, mi), norm, flag in zip(slots, norms, flags):
            stats = stats + torch.stack([norm * mi, flag * mi, loss * mi, mi])
        return upd, stats


def stream_block_sums(compute_chunk, chunk_inputs, chunk_masks, params_like,
                      clip_norm: float, *, clip_path: str = "fused",
                      guard_nonfinite: bool = False, live=None):
    """Streaming chunked accumulation of the cohort's canonical block
    partials.

    ``chunk_inputs`` is a tree whose leaves carry leading axes
    ``(n_blocks, chunks_per_block, chunk, ...)``; ``chunk_masks`` the
    matching 0/1 mask. ``compute_chunk(inputs) -> (list of delta trees,
    losses (chunk,))`` makes one chunk's unclipped deltas; they are clipped
    and folded by :func:`chunk_accumulate`. A fully masked chunk (padding
    past the realized round) is skipped: its slots would have added exactly
    ±0, so skipping gives the same bits. Which chunks are live is read from
    the mask on the host once, unless the caller knows it and passes
    ``live`` ((n_blocks, chunks_per_block) nested lists of bools).

    Returns ``(block partial tree with leading (n_blocks,) axis,
    (n_blocks, 4) stat partials)``."""
    dev = tree_leaves(params_like)[0].device
    masks = torch.as_tensor(chunk_masks, dtype=torch.float32)
    if live is None:
        count("host_reads")
        live = (masks.cpu() > 0).any(dim=-1).tolist()
    masks = masks.to(dev)
    partials, stats = [], []
    for b, block_live in enumerate(live):
        acc = (tree_zeros_like(params_like, torch.float32),
               torch.zeros((4,), dtype=torch.float32, device=dev))
        for j, chunk_live in enumerate(block_live):
            if not chunk_live:
                count("chunks_skipped")
                continue
            count("chunks_live")
            with span("engine.chunk", block=b, chunk=j,
                      clients=masks.shape[-1]):
                deltas, losses = compute_chunk(
                    tree_map(lambda l: l[b, j], chunk_inputs))
                acc = chunk_accumulate(acc, deltas, losses, masks[b, j],
                                       clip_norm, clip_path=clip_path,
                                       guard_nonfinite=guard_nonfinite)
        partials.append(acc[0])
        stats.append(acc[1])
    return _stack(partials), torch.stack(stats)


# ------------------------------------------------------- host round body


def round_compute(model: Model, params, stacked_batches,
                  client: ClientConfig, dp: DPConfig, mask=None, *,
                  cohort_chunk=None, clip_path: str = "fused"):
    """Round body: (params, stacked client batches (C, nb, B, S)) → (sum of
    clipped updates, mean norm, frac clipped, mean loss).

    ``mask`` (optional (C,) 0/1) keeps unselected slots out of the sum and
    the stats. The cohort pads to the canonical block grid (pad slots alias
    slot 0's batches under a zero mask, so they add exactly ±0) and each
    block folds ``cohort_chunk`` clients at a time. ``None`` auto-sizes the
    chunk; ``0`` is the materializing path."""
    params = strip_compute(params)
    C = tree_leaves(stacked_batches)[0].shape[0]
    padded = canon_pad(C)
    blk = padded // CANON_BLOCKS
    chunk = resolve_chunk(cohort_chunk, blk, strict=False)
    if chunk == 0:
        return _round_compute_materialized(model, params, stacked_batches,
                                           client, dp, mask)
    m = (torch.ones((C,)) if mask is None
         else torch.as_tensor(mask, dtype=torch.float32).cpu())
    pad = padded - C
    if pad:
        stacked_batches = tree_map(
            lambda l: torch.cat([l, l[:1].expand((pad,) + tuple(l.shape[1:]))]),
            stacked_batches)
        m = torch.cat([m, torch.zeros((pad,))])
    cpb = blk // chunk
    binp = tree_map(
        lambda l: l.reshape((CANON_BLOCKS, cpb, chunk) + tuple(l.shape[1:])),
        stacked_batches)
    partials, stats = stream_block_sums(
        lambda b: local_deltas(model, params, b, client),
        binp, m.reshape(CANON_BLOCKS, cpb, chunk), params, dp.clip_norm,
        clip_path=clip_path)
    return fold_round(partials, stats)[:4]


def fold_round(partials, stats):
    """Block partials and stat partials (from :func:`stream_block_sums`) →
    (sum of clipped updates, mean norm, frac clipped, mean loss, count), the
    means over the unmasked slots that the sum accepted, and their count."""
    total = tree_map(fold_blocks, partials)
    s = fold_blocks(stats)
    denom = torch.clamp(s[3], min=1.0)
    return total, s[0] / denom, s[1] / denom, s[2] / denom, s[3]


def _round_compute_materialized(model: Model, params, stacked_batches,
                                client: ClientConfig, dp: DPConfig,
                                mask=None):
    """``cohort_chunk=0``: every clipped update of the cohort at once, then
    one reduction. O(C · |params|) peak memory."""
    clipped, norms, flags, losses = client_updates(model, params,
                                                   stacked_batches, client, dp)
    if mask is None:
        total = tree_map(lambda *ls: torch.stack(ls).sum(dim=0), *clipped)
        return total, norms.mean(), flags.mean(), losses.mean()
    m = torch.as_tensor(mask, dtype=torch.float32).to(norms.device)
    denom = torch.clamp(m.sum(), min=1.0)
    total = tree_map(
        lambda *ls: torch.tensordot(m, torch.stack(ls).float(), dims=1),
        *clipped)
    return (total, (norms * m).sum() / denom, (flags * m).sum() / denom,
            (losses * m).sum() / denom)


def make_round_fn(model: Model, client: ClientConfig, dp: DPConfig,
                  cohort_chunk=None, clip_path: str = "fused"):
    """:func:`round_compute` bound to a model and configs: the host
    trainer's ``round_fn(params, stacked_batches)``. The chunk size
    re-resolves per call (the realized round size varies)."""
    def round_fn(params, stacked_batches):
        return round_compute(model, params, stacked_batches, client, dp,
                             cohort_chunk=cohort_chunk, clip_path=clip_path)
    return round_fn
