"""DP-FedAvg rounds (Algorithm 1) in plain PyTorch: the sampling, the
client steps, the clip and sum, the noise and the server step, worked out
again from the seed.

The draws are the engine's protocol, one ``torch.Generator`` on the card
seeded with the engine's seed, in this order each round: the availability
uniforms (N,), the fixed-size cohort by ``torch.multinomial`` without
replacement over the Pace-Steering weights (unavailable devices weigh
1e-30), the (padded cohort, n_batches·B) float64 uniforms of the example
indices (``floor(u · count)``), and the noise, one normal draw a leaf in
sorted-key order scaled by σ = zS/qN. Client ``c`` trains on rows
``examples[ids[c], idx[c]]``: E = 1 epoch of SGD over its batches, its
delta clipped to S; Δ̄ = Σ clip(Δ)/qN + noise; Nesterov momentum on the
server.

``fault`` plants one of the faults the comparison must catch, for the
calibration of its limits: ``"half_cohort"`` (half of the cohort left out
of the sum and the mean taken over the rest), ``"client_negated"`` (slot
0's delta negated where the client produces it), ``"state_unchanged"``
(the server step returns the parameters it was given).
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from port_bench.reference import tree as T
from port_bench.reference.precision import exact_matmul

NEVER = -(10 ** 9)
UNAVAILABLE_W = 1e-30
CANON_BLOCKS = 8
FAULTS = ("half_cohort", "client_negated", "state_unchanged")


def family(model: dict):
    """The reference module of a configuration's family."""
    return importlib.import_module(f"port_bench.reference.{model['family']}")


def canon_pad(n: int) -> int:
    return -(-max(n, 1) // CANON_BLOCKS) * CANON_BLOCKS


def _client_deltas(fam, params, tok, lab, msk, wl, model, prec):
    """Deltas (every leaf (C, …)) and mean losses (C,) of a chunk of
    clients: batches (C, n_batches, B, S)."""
    C, nb = tok.shape[:2]
    lr = wl["client"]["lr"]
    flat = [l.detach()[None].expand((C,) + tuple(l.shape)).clone()
            for l in T.leaves(params)]
    losses = []
    for i in range(nb):
        leaves = [l.requires_grad_(True) for l in flat]
        loss = fam.client_losses(T.unflatten(params, leaves), tok[:, i],
                                 lab[:, i], msk[:, i], model, prec)
        grads = torch.autograd.grad(loss.sum(), leaves)
        with torch.no_grad():
            flat = [w.detach() - lr * g for w, g in zip(leaves, grads)]
        losses.append(loss.detach())
    total = losses[0]
    for l in losses[1:]:
        total = total + l
    return [w - p[None] for w, p in zip(flat, T.leaves(params))], total / nb


def run_rounds(params0, pop: Dict[str, torch.Tensor], wl: dict,
               model: dict, engine_seed: int, n_rounds: int,
               prec: str = "float32", fault: Optional[str] = None) -> dict:
    """``n_rounds`` rounds from ``params0``. Returns the losses, the mean
    pre-clip norms, round 1's clipped mean before noise (``update1``), each
    round's noise, and the parameters after the last round."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    fam = family(model)
    dev = pop["examples"].device
    eng, cl, dp = wl["engine"], wl["client"], wl["dp"]
    examples, counts, synth = pop["examples"], pop["counts"], pop["synthetic"]
    N = counts.shape[0]
    cohort = dp["clients_per_round"]
    padded = canon_pad(cohort)
    nb, B = cl["n_local_batches"], cl["batch_size"]
    g = torch.Generator(device=dev).manual_seed(engine_seed)
    last = torch.full((N,), NEVER, dtype=torch.int32, device=dev)
    params = T.tmap(lambda l: l.detach().clone(), params0)
    mom = T.tmap(torch.zeros_like, params)
    out = {"loss": [], "mean_update_norm": [], "noise": []}
    used = cohort // 2 if fault == "half_cohort" else cohort
    with exact_matmul():
        for r in range(n_rounds):
            avail = (torch.rand((N,), generator=g, device=dev)
                     < eng["availability"]) | synth
            cooling = ((r - last) < eng["pace_cooldown"]) & ~synth
            w = torch.where(cooling, eng["pace_penalty"], 1.0).to(
                torch.float32)
            w = torch.where(avail, w, UNAVAILABLE_W).to(torch.float32)
            ids = torch.multinomial(w / torch.sum(w), cohort,
                                    replacement=False, generator=g)
            ids = F.pad(ids, (0, padded - cohort))
            slot = torch.arange(padded, device=dev) < cohort
            last = last.scatter_reduce(
                0, ids, torch.where(slot, r, NEVER).to(torch.int32),
                reduce="amax")
            u = torch.rand((padded, nb * B), generator=g,
                           dtype=torch.float64, device=dev)
            cnt = counts[ids].to(torch.int64)[:, None]
            idx = torch.minimum((u * cnt).floor().to(torch.int64), cnt - 1)
            rows = examples[ids[:used, None], idx[:used]].long()
            rows = rows.reshape(used, nb, B, -1)
            tok, lab = rows[..., :-1], rows[..., 1:]
            msk = (lab != 0).float()
            total = T.tmap(torch.zeros_like, params)
            tl, losses, norms = T.leaves(total), [], []
            step = wl["reference_chunk"]
            for c0 in range(0, used, step):
                sl = slice(c0, c0 + step)
                deltas, loss = _client_deltas(fam, params, tok[sl], lab[sl],
                                              msk[sl], wl, model, prec)
                if fault == "client_negated" and c0 == 0:
                    deltas = [torch.cat([-d[:1], d[1:]]) for d in deltas]
                sq = sum(d.reshape(d.shape[0], -1).square().sum(-1)
                         for d in deltas)
                norm = torch.sqrt(sq)
                factor = torch.clamp(dp["clip_norm"]
                                     / torch.clamp(norm, min=1e-12), max=1.0)
                for j, d in enumerate(deltas):
                    tl[j] = tl[j] + torch.tensordot(factor, d, dims=1)
                losses.append(loss)
                norms.append(norm)
            denom = float(used)
            std = dp["noise_multiplier"] * dp["clip_norm"] / float(cohort)
            noise = [torch.randn(tuple(l.shape), generator=g,
                                 dtype=torch.float32, device=dev) * std
                     for l in tl]
            mean = [l / denom for l in tl]
            if r == 0:
                out["update1"] = T.unflatten(params, mean)
            dbar = [a + b for a, b in zip(mean, noise)]
            mu, lr = dp["server_momentum"], dp["server_lr"]
            ml = [mu * m + d for m, d in zip(T.leaves(mom), dbar)]
            mom = T.unflatten(params, ml)
            if fault != "state_unchanged":
                params = T.unflatten(params, [
                    p + lr * (mu * m + d) for p, m, d in
                    zip(T.leaves(params), ml, dbar)])
            out["noise"].append(T.unflatten(params, noise))
            out["loss"].append(float(torch.cat(losses).mean()))
            out["mean_update_norm"].append(float(torch.cat(norms).mean()))
    out["params"] = params
    return out


def noise_part(noises, dp: dict) -> list:
    """The parameters' change that the noise alone makes through the
    server's Nesterov momentum (the step is linear in Δ̄), as leaves."""
    mu, lr = dp["server_momentum"], dp["server_lr"]
    mom = acc = None
    for n in noises:
        nl = T.leaves(n)
        mom = nl if mom is None else [mu * m + x for m, x in zip(mom, nl)]
        st = [mu * m + x for m, x in zip(mom, nl)]
        acc = ([lr * s for s in st] if acc is None
               else [a + lr * s for a, s in zip(acc, st)])
    return acc
