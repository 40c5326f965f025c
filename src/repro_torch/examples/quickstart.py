"""Quickstart: train the paper's production NWP model (CIFG-LSTM) with
DP-FedAvg (Algorithm 1) on a simulated device fleet, track the privacy
accountant, and decode a few next-word predictions. The port's
counterpart of the reference's ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on the card by default (the CIFG kernels in the clients' steps and in
the decode) and raises without one unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset, held_out_batch
from repro_torch.data.tokenizer import BOS
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.models.layers import lm_loss
from repro_torch.utils.device import resolve_device

VOCAB = 2000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--rounds-per-call", type=int, default=15)
    ap.add_argument("--n-users", type=int, default=300)
    ap.add_argument("--clients-per-round", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. the paper's model (scaled down): 1-layer CIFG-LSTM, tied embeddings
    cfg = get_config("gboard-cifg-lstm").with_(vocab=VOCAB, d_model=64,
                                               d_ff=128)
    model = build(cfg)

    # 2. a federated population holding a synthetic Spanish-like corpus
    corpus = BigramCorpus(vocab_size=VOCAB, seed=0)
    dataset = FederatedDataset(corpus, n_users=args.n_users, seq_len=16,
                               sentences_per_user=30)

    # 3. DP-FedAvg, Algorithm 1: clip S=0.8, fixed-size rounds, server
    #    momentum, on the engine backend (rounds_per_call rounds a call)
    dp = DPConfig(clients_per_round=args.clients_per_round,
                  noise_multiplier=0.3, clip_norm=0.8, server_opt="momentum",
                  server_lr=0.5, server_momentum=0.9)
    client = ClientConfig(local_epochs=1, batch_size=10, lr=0.3)
    pop = PopulationSim(len(dataset.users), availability=0.3, seed=0)
    trainer = FederatedTrainer(model, dataset, dp, client, pop=pop,
                               n_local_batches=3, backend="engine",
                               rounds_per_call=args.rounds_per_call,
                               device=dev)
    print(f"training {args.rounds} DP-FedAvg rounds (engine) on {dev} ...")
    trainer.train(args.rounds, log_every=args.rounds_per_call)

    # 4. held-out quality and the moments accountant
    hb = held_out_batch(corpus, 256, 16)
    with torch.no_grad():
        logits = model.forward(trainer.state.params,
                               {"tokens": torch.as_tensor(hb["tokens"])})
        loss = float(lm_loss(logits, hb["labels"], cfg.vocab, hb["mask"]))
    eps = trainer.accountant.get_epsilon(1e-6)
    print(f"\nheld-out loss: {loss:.3f}  (uniform would be "
          f"{math.log(VOCAB):.3f})")
    print(f"accountant: eps={eps:.2f} at delta=1e-6 after "
          f"{trainer.accountant.rounds} rounds")

    # 5. serve: batched next-word prediction with the recurrent cache
    prompts = torch.tensor([[BOS, 10, 11], [BOS, 20, 21]], dtype=torch.int32)
    out = generate(model, trainer.state.params, prompts, steps=5)
    print("\ngreedy continuations:")
    for row in out:
        print("  ", row.tolist())
    return {"loss": loss, "eps": eps, "rounds": trainer.accountant.rounds,
            "continuations": out.cpu().tolist()}


if __name__ == "__main__":
    main()
