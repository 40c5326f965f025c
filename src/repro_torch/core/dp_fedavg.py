"""DP-FedAvg with fixed-size federated rounds — Algorithm 1 of the paper,
the server side, over update trees:

    Δ̄ = (1/qN) Σ_k clip_S(Δ_k)          (clip → weighted average)
    θ' = θ + ServerOpt(Δ̄ + N(0, I·σ²))   with σ = zS/(qN)

:func:`aggregate` takes the round's per-user updates; :func:`finalize_round`
an already accumulated clipped sum. Noise is float32 from an explicit
``torch.Generator`` (`repro_torch.utils.pytree.tree_noise`), or injected
through ``noise`` — the port cannot draw JAX's threefry bits, so a test that
holds the port against the reference hands both the same noise.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import DPConfig
from repro_torch.core.clipping import clip_by_global_norm
from repro_torch.core.server_optim import ServerOptState, apply_update
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_noise


class RoundStats(NamedTuple):
    mean_update_norm: torch.Tensor   # mean pre-clip ‖Δ_k‖
    frac_clipped: torch.Tensor       # fraction of users whose update was clipped
    noise_std: float                 # σ actually applied


def aggregate(user_updates, generator: Optional[torch.Generator],
              dp: DPConfig, n_clients: int = None, noise=None):
    """user_updates: a list of update trees → (noised mean Δ, stats)."""
    n = n_clients or len(user_updates)
    clipped, norms, flags = zip(*(clip_by_global_norm(u, dp.clip_norm)
                                  for u in user_updates))
    total = tree_map(lambda *ls: torch.stack([l.float() for l in ls]).sum(0),
                     *clipped)
    return finalize_round(total, n, generator, dp,
                          stats=(torch.stack(norms).mean(),
                                 torch.stack(flags).mean()), noise=noise)


def finalize_round(clipped_sum, n_clients, generator: Optional[torch.Generator],
                   dp: DPConfig, stats=None, noise=None):
    """clipped_sum: Σ_k clip_S(Δ_k) (float32 tree). Divide by the round
    size, add N(0, σ²) with σ = z·S/round_size — drawn from ``generator``,
    or ``noise`` (a tree of the same shapes, already scaled by σ) when given
    — and return (Δ̄, RoundStats)."""
    n = float(n_clients)
    sigma = dp.noise_multiplier * dp.clip_norm / n
    mean = tree_map(lambda l: l / n, clipped_sum)
    if noise is None:
        noise = tree_noise(generator, mean, sigma)
    elif [tuple(l.shape) for l in tree_leaves(noise)] != \
            [tuple(l.shape) for l in tree_leaves(mean)]:
        raise ValueError("injected noise must match the update's shapes")
    noised = tree_map(torch.add, mean, noise)
    ref = tree_leaves(mean)[0]
    mean_norm, frac = stats if stats is not None else (
        ref.new_zeros(()), ref.new_zeros(()))
    return noised, RoundStats(mean_norm, frac, sigma)


def server_step(params, opt_state: ServerOptState, delta, dp: DPConfig):
    """θ ← θ + ServerOpt(Δ̄)."""
    return apply_update(params, delta, opt_state, dp)
