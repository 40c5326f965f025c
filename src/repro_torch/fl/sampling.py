"""Client sampling for federated rounds.

The paper's Algorithm 1 uses *fixed-size* rounds: exactly qN users sampled
without replacement — in the production system, from the (much smaller,
Pace-Steering-shaped) set of checked-in devices, which is precisely the gap
between deployed mechanism and provable guarantee discussed in §V-A.
Poisson sampling (the [MRTZ17] scheme) is provided for comparison.

These are the host-loop (numpy) samplers, the reference's own: with one
seed the port and the reference sample the same cohorts.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np

from repro_torch.fl.population import PopulationSim


def fixed_size_sample(rng: np.random.Generator, ids: np.ndarray, k: int,
                      weights: Optional[np.ndarray] = None, *,
                      min_size: Optional[int] = None) -> np.ndarray:
    """Sample exactly k without replacement (weighted when Pace Steering
    shapes priorities).

    An under-populated check-in pool shrinks the round below the k that
    σ = zS/qN was calibrated for — never silently: a short round warns with
    realized-vs-target, and falls below ``min_size`` (a report goal) it
    raises instead, the host-loop analogue of the engine's round abort."""
    realized = min(k, ids.shape[0])
    if min_size is not None and realized < min_size:
        raise ValueError(
            f"check-in pool supports only {realized} of the {k} requested "
            f"clients — below the report goal ({min_size}); the round must "
            "abort rather than release with σ calibrated to the full round")
    if realized < k:
        warnings.warn(
            f"check-in pool supports only {realized} of the {k} requested "
            "clients; σ = zS/qN is calibrated to the full round size",
            RuntimeWarning, stacklevel=2)
    return rng.choice(ids, size=realized, replace=False, p=weights)


def poisson_sample(rng: np.random.Generator, ids: np.ndarray,
                   q: float) -> np.ndarray:
    return ids[rng.random(ids.shape[0]) < q]


def sample_round(pop: PopulationSim, rng: np.random.Generator,
                 round_idx: int, clients_per_round: int,
                 scheme: str = "fixed",
                 min_size: Optional[int] = None) -> np.ndarray:
    """Production round sampling: check-in → Pace-Steering weights → sample.
    ``min_size`` (a report goal) makes a too-small fixed round raise instead
    of shrinking silently — see :func:`fixed_size_sample`."""
    checked = pop.checked_in(round_idx)
    if scheme == "poisson":
        chosen = poisson_sample(rng, checked,
                                clients_per_round / pop.n_users)
    else:
        w = pop.selection_weights(checked, round_idx)
        chosen = fixed_size_sample(rng, checked, clients_per_round, w,
                                   min_size=min_size)
    pop.mark_participated(chosen, round_idx)
    return chosen
