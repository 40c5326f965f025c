"""Federated training CLI of the port: DP-FedAvg (Algorithm 1) on a
simulated device population through ``FederatedTrainer(backend="host")``,
with the RDP accountant and a checkpoint in the reference's format. Runs on
the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --rounds 20 \\
        --clients-per-round 40 --noise-multiplier 0.3
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --vocab 300 --rounds 2 --n-users 60 --clients-per-round 8

The flags are the reference's for the host path; the engine backends, the
canary injection and the fault model are not ported yet.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.models import build
from repro_torch.train import checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gboard-cifg-lstm")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--n-users", type=int, default=300)
    ap.add_argument("--clients-per-round", type=int, default=40)
    ap.add_argument("--noise-multiplier", type=float, default=0.3)
    ap.add_argument("--clip-norm", type=float, default=0.8)
    ap.add_argument("--server-opt", default="momentum",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--server-lr", type=float, default=0.5)
    ap.add_argument("--server-momentum", type=float, default=0.9)
    ap.add_argument("--client-lr", type=float, default=0.3)
    ap.add_argument("--client-batch", type=int, default=10)
    ap.add_argument("--local-epochs", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--out", default="experiments/runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="host", choices=["host"],
                    help="host = numpy sampling and batching, round body "
                         "on the device (the only backend ported so far)")
    ap.add_argument("--cohort-chunk", type=int, default=None,
                    help="stream the round sum this many clients at a time "
                         "(default: auto — largest divisor of the canonical "
                         "block size ≤ 32; 0 = materializing path)")
    ap.add_argument("--clip-path", default="fused", choices=["fused", "tree"],
                    help="per-client clip→accumulate: the CUDA dp_clip "
                         "kernels (fused) or plain tensor ops (tree)")
    ap.add_argument("--cell-path", default=None,
                    choices=["auto", "fused", "seq", "ref"],
                    help="lstm recurrence: the CUDA cell kernel with the "
                         "time-fused backward (fused), the plain cell with "
                         "the same backward (seq), plain autograd (ref), or "
                         "auto = fused on CUDA / seq on the CPU (default: "
                         "the config's cell_path)")
    ap.add_argument("--availability", type=float, default=0.3,
                    help="per-round device check-in probability; keep "
                         "availability·n_users above clients_per_round")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "lstm":
        cfg = cfg.with_(vocab=args.vocab)
    if args.cell_path is not None:
        cfg = cfg.with_(cell_path=args.cell_path)
    model = build(cfg)

    corpus = BigramCorpus(vocab_size=cfg.vocab, seed=args.seed)
    ds = FederatedDataset(corpus, n_users=args.n_users, seq_len=args.seq_len,
                          sentences_per_user=30)
    dp = DPConfig(clients_per_round=args.clients_per_round,
                  noise_multiplier=args.noise_multiplier,
                  clip_norm=args.clip_norm, server_opt=args.server_opt,
                  server_lr=args.server_lr,
                  server_momentum=args.server_momentum)
    cl = ClientConfig(local_epochs=args.local_epochs,
                      batch_size=args.client_batch, lr=args.client_lr)
    pop = PopulationSim(len(ds.users), availability=args.availability,
                        seed=args.seed)
    trainer = FederatedTrainer(model, ds, dp, cl, pop=pop, seed=args.seed,
                               n_local_batches=3, backend=args.backend,
                               cohort_chunk=args.cohort_chunk,
                               clip_path=args.clip_path, device=args.device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    trainer.train(args.rounds, log_every=max(1, args.rounds // 20))

    eps = trainer.accountant.get_epsilon(1e-6)
    print(f"RDP accountant after {args.rounds} rounds "
          f"({args.rounds} committed): eps={eps:.2f} at delta=1e-6 "
          f"(q={trainer.accountant.q:.4f})")

    ck = out / f"{args.arch}_r{args.rounds}.msgpack"
    checkpoint.save(ck, trainer.state.params,
                    meta={"arch": args.arch, "rounds": str(args.rounds),
                          "eps@1e-6": f"{eps:.3f}"})
    (out / f"{args.arch}_r{args.rounds}_history.json").write_text(
        json.dumps(trainer.state.history[-50:], indent=1))
    print(f"checkpoint: {ck}")
    return ck


if __name__ == "__main__":
    main()
