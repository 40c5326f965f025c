"""Privacy accounting walkthrough (paper §V-A, Table 5): reproduce the
hypothetical (ε, δ) bounds and explore the noise / participation trade-off
with the port's moments accountant. The port's counterpart of the
reference's ``examples/dp_accounting.py``.

    PYTHONPATH=src python -m repro_torch.examples.dp_accounting

The accountant is host arithmetic: unlike the other examples it takes no
``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch.core.accountant import MomentsAccountant, table5_epsilon

PAPER = {2_000_000: 9.86, 3_000_000: 6.73, 4_000_000: 5.36,
         5_000_000: 4.54, 10_000_000: 3.27}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2000)
    args = ap.parse_args(argv)
    out = {"table5": {}, "z_sweep": {}, "qn_sweep": {}}

    print(f"Table 5 (T={args.rounds}, qN=20000, z=0.8, delta=N^-1.1):")
    print(f"{'N':>5s} {'paper':>7s} {'ours(WOR)':>10s} {'ours(Poisson)':>14s}")
    for N, ep in PAPER.items():
        wor = table5_epsilon(N, rounds=args.rounds, sampling="wor")
        poi = table5_epsilon(N, rounds=args.rounds, sampling="poisson")
        out["table5"][N] = (wor, poi)
        print(f"{N // 10**6:4d}M {ep:7.2f} {wor:10.2f} {poi:14.2f}")

    print("\nWhy the paper adds sigma=3.2e-5 of noise:")
    print("  sigma = z*S/(qN) = 0.8*0.8/20000 =", 0.8 * 0.8 / 20000)

    print("\nnoise multiplier sweep at N=4M (what z buys you):")
    for z in (0.4, 0.8, 1.6, 3.2):
        acc = MomentsAccountant(q=20000 / 4e6, noise_multiplier=z,
                                sampling="wor")
        acc.step(args.rounds)
        out["z_sweep"][z] = acc.get_epsilon(4e6 ** -1.1)
        print(f"  z={z:0.1f}  eps={out['z_sweep'][z]:8.2f}")

    print("\nclients-per-round sweep at N=4M, z=0.8 (amplification):")
    for qn in (5_000, 20_000, 80_000):
        acc = MomentsAccountant(q=qn / 4e6, noise_multiplier=0.8,
                                sampling="wor")
        acc.step(args.rounds)
        out["qn_sweep"][qn] = acc.get_epsilon(4e6 ** -1.1)
        print(f"  qN={qn:6d}  eps={out['qn_sweep'][qn]:8.2f}  "
              f"(but sigma={0.8 * 0.8 / qn:.2e} shrinks too)")
    return out


if __name__ == "__main__":
    main()
