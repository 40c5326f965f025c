"""End-to-end Federated Secret Sharer measurement (paper §IV, Table 4),
reduced scale: inject canary-carrying synthetic devices into the training
population, train with DP-FedAvg, then measure unintended memorization by
Random-Sampling rank and Beam Search. The port's counterpart of the
reference's ``examples/secret_sharer_e2e.py``.

    PYTHONPATH=src python -m repro_torch.examples.secret_sharer_e2e
    PYTHONPATH=src python -m repro_torch.examples.secret_sharer_e2e --device cpu

Runs on the card by default and raises without one unless ``--device cpu``
is given. Canaries and the Random-Sampling pool come from seeded
generators (torch's, not the reference's bits).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.core.secret_sharer import (canary_eval_fn, canary_extracted,
                                            make_canaries,
                                            random_sampling_ranks)
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.round import FederatedTrainer
from repro_torch.models import build
from repro_torch.utils.device import resolve_device

VOCAB = 1000
GRID = [(1, 1), (4, 20), (16, 20)]   # reduced (n_u, n_e) grid


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=80)
    ap.add_argument("--rounds-per-call", type=int, default=20)
    ap.add_argument("--n-users", type=int, default=250)
    ap.add_argument("--rs-samples", type=int, default=10_000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("gboard-cifg-lstm").with_(vocab=VOCAB, d_model=64,
                                               d_ff=128)
    model = build(cfg)
    corpus = BigramCorpus(vocab_size=VOCAB, seed=0)
    dataset = FederatedDataset(corpus, n_users=args.n_users, seq_len=16,
                               sentences_per_user=30)
    canaries = make_canaries(torch.Generator().manual_seed(42), vocab=VOCAB,
                             grid=GRID, per_config=1)
    synth = dataset.inject_canaries(canaries)
    print(f"population: {len(dataset.users)} devices "
          f"({len(synth)} secret-sharing synthetic devices)")

    dp = DPConfig(clients_per_round=40, noise_multiplier=0.3, clip_norm=0.8,
                  server_opt="momentum", server_lr=0.5, server_momentum=0.9)
    client = ClientConfig(local_epochs=1, batch_size=10, lr=0.3)
    # the engine backend with the canary hook: the memorization-vs-round
    # curve is recorded while training
    trainer = FederatedTrainer(model, dataset, dp, client, n_local_batches=3,
                               backend="engine",
                               rounds_per_call=args.rounds_per_call,
                               eval_fn=canary_eval_fn(model, canaries),
                               eval_every=args.rounds_per_call, device=dev)
    print(f"training {args.rounds} rounds on {dev} with canary devices in "
          "the population ...")
    trainer.train(args.rounds, log_every=args.rounds_per_call)

    ev = trainer.eval_history
    for r, row in zip(ev["round"][ev["mask"]],
                      ev["values"]["canary_logppl"][ev["mask"]]):
        lps = "  ".join(f"{v:6.2f}" for v in row)
        print(f"  round {int(r):3d}  canary -log P(s|p): {lps}")

    params = trainer.state.params
    ranks = random_sampling_ranks(
        model, params, canaries,
        torch.Generator(dev).manual_seed(7), n_samples=args.rs_samples,
        batch_size=2048)
    out = {"ranks": [int(r) for r in ranks], "extracted": []}
    print(f"\n(n_u, n_e) -> RS rank (of {args.rs_samples}) | beam-extracted?"
          "   [paper Table 4]")
    for c, rank in zip(canaries, ranks):
        bs = canary_extracted(model, params, c)
        out["extracted"].append(bool(bs))
        print(f"  ({c.n_u:2d},{c.n_e:3d})  rank={int(rank):6d}   "
              f"extracted={'YES' if bs else 'no '}")
    print("\nexpected: (1,1) far from memorized; (16,20) memorized "
          "(rank→0).")
    return out


if __name__ == "__main__":
    main()
