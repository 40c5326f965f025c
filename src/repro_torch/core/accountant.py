"""RDP moments accountant for the subsampled Gaussian mechanism.

The paper (§V-A) accounts privacy via: per-round RDP of the subsampled
Gaussian [Mir17; MTZ19; WBK19] → T-fold composition [Mir17, Prop. 1] → (ε,δ)
conversion [Mir17, Prop. 3 / the tightened Balle et al. bound].

We implement the Poisson-subsampled Gaussian RDP in stable log-space (the
binomial expansion over integer orders α):

    RDP(α) = 1/(α−1) · log Σ_{k=0}^{α} C(α,k)(1−q)^{α−k} q^k · e^{k(k−1)/(2z²)}

The paper's Table 5 uses fixed-size sampling without replacement (WBK19);
at these parameters (q ≤ 0.01, z = 0.8) the Poisson bound is numerically
close — the comparison is part of `benchmarks/bench_accounting.py`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, Sequence

DEFAULT_ORDERS = tuple(range(2, 129)) + tuple(range(130, 512, 4))


def _log_binom(n: int, k: int) -> float:
    return (math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1))


def _logsumexp(xs: Iterable[float]) -> float:
    xs = list(xs)
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_subsampled_gaussian(q: float, z: float, order: int) -> float:
    """RDP ε_α of one round of the Poisson-subsampled Gaussian mechanism."""
    if q == 0.0:
        return 0.0
    if z == 0.0:
        return math.inf  # no noise ⇒ no DP guarantee
    if q == 1.0:
        return order / (2 * z * z)
    if order <= 1 or int(order) != order:
        raise ValueError("integer orders > 1 only")
    a = int(order)
    log_terms = []
    for k in range(a + 1):
        log_coef = _log_binom(a, k) + k * math.log(q) + (a - k) * math.log1p(-q)
        log_terms.append(log_coef + (k * (k - 1)) / (2 * z * z))
    return _logsumexp(log_terms) / (a - 1)


def rdp_subsampled_gaussian_wor(q: float, z: float, order: int) -> float:
    """RDP bound for the *fixed-size sampling without replacement* subsampled
    Gaussian [WBK19, Thm 9 simplified for a Gaussian base mechanism] — the
    sampling scheme the paper actually deploys (Algorithm 1) and accounts
    with. Replace-one adjacency; the ε(∞)-dependent factors collapse to the
    min{…}=2 / 4(e^{ε(2)}−1) branches since the Gaussian has ε(∞)=∞."""
    if q == 0.0:
        return 0.0
    if z == 0.0:
        return math.inf  # no noise ⇒ no DP guarantee
    a = int(order)
    if a <= 1 or a != order:
        raise ValueError("integer orders > 1 only")
    gauss = lambda j: j / (2 * z * z)
    terms = [0.0]  # log(1)
    terms.append(_log_binom(a, 2) + 2 * math.log(q) + math.log(4.0)
                 + math.log(math.expm1(gauss(2))))
    for j in range(3, a + 1):
        terms.append(_log_binom(a, j) + j * math.log(q) + math.log(2.0)
                     + (j - 1) * gauss(j))
    return _logsumexp(terms) / (a - 1)


def compose(rdp_per_round: Sequence[float], rounds: int) -> list:
    """[Mir17 Prop. 1]: RDP composes additively order-wise."""
    return [r * rounds for r in rdp_per_round]


def eps_from_rdp(orders: Sequence[int], rdp: Sequence[float],
                 delta: float) -> tuple:
    """Tight RDP→DP conversion (Balle–Barthe–Gaboardi–Hsu–Sato '20 form used
    by tf-privacy): ε = RDP(α) + log((α−1)/α) − (log δ + log α)/(α−1)."""
    best_eps, best_order = math.inf, None
    for a, r in zip(orders, rdp):
        if a <= 1:
            continue
        eps = r + math.log((a - 1) / a) - (math.log(delta) + math.log(a)) / (a - 1)
        if eps < best_eps:
            best_eps, best_order = eps, a
    return best_eps, best_order


@dataclass
class MomentsAccountant:
    """Tracks composed RDP over federated rounds (Algorithm 1's 𝓜)."""

    q: float                   # round participation fraction (qN/N)
    noise_multiplier: float    # z
    orders: Sequence[int] = DEFAULT_ORDERS
    sampling: str = "poisson"  # "poisson" (MTZ19) | "wor" (WBK19, the paper's)

    def __post_init__(self):
        fn = (rdp_subsampled_gaussian if self.sampling == "poisson"
              else rdp_subsampled_gaussian_wor)
        self._per_round = [fn(self.q, self.noise_multiplier, a)
                           for a in self.orders]
        self._rounds = 0

    def step(self, n: int = 1) -> None:
        self._rounds += n

    def record_round(self, committed: bool = True) -> None:
        """Record one round under the production fault protocol: an aborted
        round (survivors < report goal) released *nothing* — the noised sum
        was never applied or published — so it composes nothing and spends
        zero budget. Only committed rounds advance the composition count."""
        if committed:
            self._rounds += 1

    def restore_rounds(self, rounds: int) -> None:
        """Reset the composition count from a durable run-state snapshot
        (crash resume). The accountant is otherwise stateless: per-round RDP
        is recomputed from (q, z) at construction."""
        if rounds < 0:
            raise ValueError(f"rounds must be >= 0, got {rounds}")
        self._rounds = int(rounds)

    @property
    def rounds(self) -> int:
        return self._rounds

    def get_epsilon(self, delta: float, rounds: int = None) -> float:
        t = self._rounds if rounds is None else rounds
        rdp = compose(self._per_round, t)
        eps, _ = eps_from_rdp(self.orders, rdp, delta)
        return eps


def table5_epsilon(population: int, clients_per_round: int = 20_000,
                   noise_multiplier: float = 0.8, rounds: int = 2_000,
                   delta: float = None, sampling: str = "wor") -> float:
    """Reproduce one row of the paper's Table 5 (hypothetical ε upper bounds
    for the production run: T=2000, qN=20000, z=0.8, δ=N^-1.1)."""
    q = clients_per_round / population
    if delta is None:
        delta = population ** -1.1
    acc = MomentsAccountant(q=q, noise_multiplier=noise_multiplier,
                            sampling=sampling)
    acc.step(rounds)
    return acc.get_epsilon(delta)
