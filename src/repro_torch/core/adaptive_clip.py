"""Adaptive clipping [TAM19 — Thakkar, Andrew, McMahan, "Differentially
Private Learning with Adaptive Clipping"]: the port of
``repro.core.adaptive_clip``. Instead of a fixed S, track the γ-quantile
of per-user update norms with a DP-protected geometric update:

    b_t   = (1/n) Σ_k 1[‖Δ_k‖ ≤ S_t] + N(0, σ_b²)   (noisy clipped fraction)
    S_t+1 = S_t · exp(−η_C (b_t − γ))

The indicator sum has sensitivity 1 per user, so the noisy fraction costs
a small additional privacy budget (a second Gaussian mechanism with noise
multiplier z_b). The draws come from an explicit ``torch.Generator`` where
the reference splits a JAX key; with ``noise_multiplier_b = 0`` the update
is deterministic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.utils.device import resolve_device


class AdaptiveClipState(NamedTuple):
    clip_norm: torch.Tensor    # S_t (float32 scalar)
    target_quantile: float     # γ
    lr: float                  # η_C
    noise_multiplier_b: float  # z_b for the fraction estimate


def init_adaptive_clip(initial_clip: float = 0.8,
                       target_quantile: float = 0.9, lr: float = 0.2,
                       noise_multiplier_b: float = 10.0, *, device=None
                       ) -> AdaptiveClipState:
    """S_0 on ``device`` (``None`` → ``cuda``; raises without a GPU)."""
    return AdaptiveClipState(
        torch.tensor(initial_clip, dtype=torch.float32,
                     device=resolve_device(device)),
        target_quantile, lr, noise_multiplier_b)


def update_clip_norm(state: AdaptiveClipState, frac_below: torch.Tensor,
                     n_clients: int, generator: torch.Generator
                     ) -> AdaptiveClipState:
    """frac_below: exact fraction of users with ‖Δ_k‖ ≤ S_t this round.
    Adds the DP noise (one standard normal drawn from ``generator``, on
    the generator's device) to the fraction, then the geometric update."""
    sigma_b = state.noise_multiplier_b / n_clients
    z = torch.randn((), generator=generator, dtype=torch.float32,
                    device=generator.device).to(state.clip_norm.device)
    noisy = frac_below + sigma_b * z
    new_s = state.clip_norm * torch.exp(
        -state.lr * (noisy - state.target_quantile))
    return state._replace(clip_norm=new_s)


def adaptive_rounds(norms_per_round, n_clients: int,
                    generator: torch.Generator, state: AdaptiveClipState):
    """Simulation helper: the adaptation over a sequence of per-round
    user-norm arrays, one draw a round → (final state, the S_t trajectory
    as floats)."""
    traj = [float(state.clip_norm)]
    for norms in norms_per_round:
        norms = torch.as_tensor(norms, device=state.clip_norm.device)
        frac = (norms <= state.clip_norm).float().mean()
        state = update_clip_norm(state, frac, n_clients, generator)
        traj.append(float(state.clip_norm))
    return state, traj
