"""Production round fault model (the reference's ``fl/faults.py``): dropout,
stragglers, corrupt reports, over-selection with report goals (paper §III;
arXiv 1710.06963 §B; arXiv 2305.18465).

A deployed fleet never delivers the simulator's happy path: devices accept
a training task and vanish, report after the server has closed the round,
or deliver garbage bytes. The production protocol over-selects —
``ceil(target / expected_survival)`` clients, so that the expected survivor
count is the target — and closes each round against a **report goal**:
with fewer usable reports the round *aborts* (no server step, nothing
released, no privacy budget spent); when it commits, σ is calibrated to the
report goal, never to the realized survivor count.

The fault stream is *seeded and stateless per round*: one round's fates
are a pure function of ``(fault seed, round index, slot)``, drawn on the
host from a CPU ``torch.Generator`` seeded through
``numpy.random.SeedSequence([seed, round_idx])``. So

* turning faults on never touches the engine's training generator, whose
  draws (and so the fault-free trajectory family) stay as they were;
* a resumed run reproduces the fault stream with no saved fault state: the
  position in the stream is the round index;
* the fates are known on the host before the round runs, so a fixed-size
  round still reads nothing back from the device.

Per-slot fates:

* **dropped** — accepted the task, never reports: P = ``dropout_prob``;
* **late** — a ``straggler_prob`` fraction of devices draw an
  Exponential(``straggler_mean_delay``) report latency and miss the
  ``round_deadline`` with P = exp(−deadline/mean); a dropped slot is never
  late;
* **corrupt** — reported on time, but the payload is non-finite garbage.
  The engine injects it into the update values and the server-side guard
  (`fl.client.chunk_accumulate(guard_nonfinite=True)`) rejects it.

Dropped, late and rejected slots add exactly ±0 to the round sum through
the same mask that keeps Poisson-excluded slots out.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["FaultConfig", "FaultFates", "fault_fates", "fault_generator"]


class FaultFates(NamedTuple):
    """Per-slot fates for one round — all ``(n_slots,)`` bool, on the CPU."""

    reported: torch.Tensor   # on time: neither dropped nor late
    corrupt: torch.Tensor    # reported, but the payload is non-finite garbage
    dropped: torch.Tensor    # never reports
    late: torch.Tensor       # reports after the round deadline


@dataclass(frozen=True)
class FaultConfig:
    """Seeded fleet fault model driving `fl.engine.SimEngine`'s
    over-selection / report-goal round protocol.

    ``report_goal=None`` derives the goal as ``ceil(goal_frac · target)``
    from the target cohort. ``over_select=False`` disables the compensating
    over-sampling (rounds then shrink by the fault rate — useful for forcing
    aborts in tests)."""

    seed: int = 0
    dropout_prob: float = 0.0
    straggler_prob: float = 0.0
    straggler_mean_delay: float = 1.0
    round_deadline: float = 3.0
    corrupt_prob: float = 0.0
    report_goal: Optional[int] = None
    goal_frac: float = 0.8
    over_select: bool = True

    def __post_init__(self):
        for name in ("dropout_prob", "straggler_prob", "corrupt_prob"):
            v = getattr(self, name)
            if not 0.0 <= v < 1.0:
                raise ValueError(
                    f"FaultConfig.{name} must be in [0, 1), got {v!r} — a "
                    "probability of 1 means no round can ever commit")
        if self.straggler_mean_delay <= 0 or self.round_deadline <= 0:
            raise ValueError(
                "FaultConfig straggler_mean_delay and round_deadline must "
                f"be positive, got {self.straggler_mean_delay!r} / "
                f"{self.round_deadline!r}")
        if not 0.0 < self.goal_frac <= 1.0:
            raise ValueError(
                f"FaultConfig.goal_frac must be in (0, 1], got "
                f"{self.goal_frac!r}")
        if self.report_goal is not None and self.report_goal < 1:
            raise ValueError(
                f"FaultConfig.report_goal must be >= 1, got "
                f"{self.report_goal!r}")

    @property
    def late_prob(self) -> float:
        """P(a slot is a straggler *and* its report misses the deadline)."""
        return self.straggler_prob * math.exp(
            -self.round_deadline / self.straggler_mean_delay)

    @property
    def on_time_prob(self) -> float:
        return (1.0 - self.dropout_prob) * (1.0 - self.late_prob)

    @property
    def expected_survival(self) -> float:
        """P(a selected slot reports on time and passes the non-finite
        guard) — the denominator of the over-selection factor."""
        return self.on_time_prob * (1.0 - self.corrupt_prob)

    def resolve_report_goal(self, target: int) -> int:
        """Minimum usable-report count for a round to commit. σ is always
        calibrated to this number, never to the realized survivor count."""
        if self.report_goal is not None:
            return self.report_goal
        return max(1, int(math.ceil(self.goal_frac * target)))

    def over_selection(self, target: int) -> int:
        """``ceil(target / expected_survival)`` — sample enough clients that
        the *expected* survivor count is the full target [1710.06963 §B]."""
        if not self.over_select:
            return target
        return int(math.ceil(target / self.expected_survival))


def fault_generator(seed: int, round_idx: int) -> torch.Generator:
    """The round's own CPU generator: seeded from ``(seed, round_idx)``, so
    that rounds draw disjoint, order-free streams."""
    state = np.random.SeedSequence([int(seed), int(round_idx)])
    return torch.Generator().manual_seed(
        int(state.generate_state(1, np.uint64)[0] >> np.uint64(1)))


def fault_fates(generator: torch.Generator, n_slots: int,
                cfg: FaultConfig) -> FaultFates:
    """Draw one round's per-slot fates from ``generator`` (a CPU generator,
    :func:`fault_generator`).

    The uniforms are thresholded by the probabilities (monotone coupling):
    for a fixed generator state, raising ``dropout_prob`` only grows the
    dropped set. A dropped slot can't also be late (it never reports at
    all); a corrupt flag only matters on a reported slot."""
    u_drop = torch.rand((n_slots,), generator=generator, dtype=torch.float64)
    u_strag = torch.rand((n_slots,), generator=generator, dtype=torch.float64)
    delay = cfg.straggler_mean_delay * torch.empty(
        (n_slots,), dtype=torch.float64).exponential_(generator=generator)
    u_corrupt = torch.rand((n_slots,), generator=generator,
                           dtype=torch.float64)
    dropped = u_drop < cfg.dropout_prob
    straggler = u_strag < cfg.straggler_prob
    late = straggler & (delay > cfg.round_deadline) & ~dropped
    reported = ~dropped & ~late
    return FaultFates(reported=reported,
                      corrupt=reported & (u_corrupt < cfg.corrupt_prob),
                      dropped=dropped, late=late)
