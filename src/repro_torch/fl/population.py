"""Device population simulation: availability gating + Pace Steering.

The paper (§V-A) describes why production FL breaks the accountant's
uniform-sampling assumption: devices only *check in* when idle, charging and
on unmetered Wi-Fi, and Pace Steering [BEG+19] lowers a device's scheduling
priority right after it participates. Secret-sharing synthetic devices are
always available and exempt from Pace Steering — which is why the paper's
canary devices participate 1–2 orders of magnitude more than real ones
(Table 3: each synthetic device participates ≈1150 times in 2000 rounds).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class PopulationSim:
    n_users: int
    availability: float = 0.1          # P(device meets check-in criteria)
    pace_cooldown: int = 50            # rounds of lowered priority after participating
    pace_penalty: float = 0.01         # relative selection weight while cooling down
    synthetic_ids: Sequence[int] = ()  # always-available, no Pace Steering
    seed: int = 0
    _last_round: np.ndarray = field(init=False, default=None)

    def __post_init__(self):
        self._last_round = np.full(self.n_users, -(10 ** 9), np.int64)
        self._synth = np.zeros(self.n_users, bool)
        if len(self.synthetic_ids):
            self._synth[np.asarray(self.synthetic_ids)] = True
        self._rng = np.random.default_rng(self.seed)

    def checked_in(self, round_idx: int) -> np.ndarray:
        """ids of devices meeting availability criteria this round."""
        avail = self._rng.random(self.n_users) < self.availability
        avail |= self._synth                    # synthetic devices always on
        return np.nonzero(avail)[0]

    def selection_weights(self, ids: np.ndarray, round_idx: int) -> np.ndarray:
        """Pace Steering: devices that participated recently are deprioritized
        (synthetic devices exempt, per the paper's experiment setup)."""
        cooling = (round_idx - self._last_round[ids]) < self.pace_cooldown
        cooling &= ~self._synth[ids]
        w = np.where(cooling, self.pace_penalty, 1.0)
        return w / w.sum()

    def mark_participated(self, ids: np.ndarray, round_idx: int) -> None:
        self._last_round[ids] = round_idx

    def absorb_last_round(self, last_round: np.ndarray) -> None:
        """Overwrite the Pace-Steering recency vector wholesale — used to
        mirror device-resident engine state (`EngineState.last_round`) back
        into the host population after an engine run."""
        self._last_round = np.asarray(last_round, np.int64)


def participation_rates(participation: np.ndarray, synthetic: np.ndarray,
                        rounds: int):
    """(synthetic, real) mean participations *per round* from a per-device
    participation-count vector — works on both the host `PopulationSim`
    tallies and `SimEngine` state (`EngineState.participation`), which is
    how Table 3's synthetic-vs-real participation gap is measured."""
    part = np.asarray(participation, np.float64)
    synth = np.asarray(synthetic, bool)
    synth_rate = part[synth].mean() / rounds if synth.any() else 0.0
    real_rate = part[~synth].mean() / rounds if (~synth).any() else 0.0
    return synth_rate, real_rate
