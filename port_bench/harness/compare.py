"""The numbers that decide ``correct``, and the verdict.

* `leaf_gaps` — for each leaf the gap between the program's norm of the
  leaf and the reference's, against the larger of the reference's norm of
  that leaf and of the median leaf; the worst leaf's gap and the median of
  the gaps (steady where one small leaf is noisy). Leaves whose reference
  gradient is nought to rounding (under a thousandth of the median
  leaf's) are left out.
* `rel_gap` — the largest relative gap of paired scalars.
* `rank_gap` — how far a Random-Sampling rank lies from the reference's
  scores: the least shift of the canary's reference score that gives the
  program's rank among the reference's pool scores, over the pool scores'
  interquartile range.

Every number compared is judged against its limit; a number that is not
finite fails.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

LEAF_FLOOR = 1e-3


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
              ref_grad: List[torch.Tensor]) -> Tuple[float, float]:
    """(the worst leaf's gap, the median of the leaves' gaps)."""
    pn = [float(torch.linalg.vector_norm(p.float())) for p in prog]
    rn = [float(torch.linalg.vector_norm(r.float())) for r in ref]
    gn = [float(torch.linalg.vector_norm(g.float())) for g in ref_grad]
    med, gmed = statistics.median(rn), statistics.median(gn)
    gaps = []
    for p, r, g in zip(pn, rn, gn):
        if g < LEAF_FLOOR * gmed:
            continue
        gap = abs(p - r) / max(r, med, 1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return max(gaps), statistics.median(gaps)


def rel_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    worst = 0.0
    for p, r in zip(prog, ref):
        gap = abs(p - r) / max(abs(r), 1e-30)
        worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def rank_gap(rank: int, canary: float, pool_sorted: torch.Tensor) -> float:
    """``pool_sorted`` ascending. A threshold t gives rank k (the count of
    scores below t) when ``pool[k−1] < t ≤ pool[k]``."""
    n = pool_sorted.numel()
    if not 0 <= rank <= n:
        return math.inf
    lo = float(pool_sorted[rank - 1]) if rank > 0 else -math.inf
    hi = float(pool_sorted[rank]) if rank < n else math.inf
    shift = 0.0 if lo < canary <= hi else min(abs(canary - lo),
                                              abs(canary - hi))
    q1, q3 = (float(pool_sorted[int(f * (n - 1))]) for f in (0.25, 0.75))
    return shift / max(q3 - q1, 1e-30)


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(math.isfinite(checks[k]) and checks[k] <= limits[k]
               for k in limits)
