"""Federated training CLI of the port: DP-FedAvg (Algorithm 1) on a
simulated device population through ``FederatedTrainer`` — by default the
simulation engine (`repro_torch.fl.engine`) — with the RDP accountant,
optional secret-sharing canary devices, and a checkpoint in the reference's
format. Runs on the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --rounds 20 \\
        --clients-per-round 40 --noise-multiplier 0.3 --inject-canaries
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --vocab 300 --rounds 2 --n-users 60 --clients-per-round 8

A faulty fleet (dropout, stragglers against a deadline, corrupt reports;
rounds over-select and commit against a report goal), a run-state snapshot
every 2 rounds, a simulated crash after round 4, then the resumed run, whose
final checkpoint is byte for byte the uninterrupted run's:

    PYTHONPATH=src python -m repro_torch.launch.train --rounds 8 \\
        --fault-dropout 0.1 --fault-straggler 0.2 --fault-corrupt 0.05 \\
        --checkpoint-every 2 --crash-after 4 --out /tmp/run
    PYTHONPATH=src python -m repro_torch.launch.train --rounds 8 \\
        --fault-dropout 0.1 --fault-straggler 0.2 --fault-corrupt 0.05 \\
        --checkpoint-every 2 --resume --out /tmp/run

The cohort sharded over ranks, one process each, under ``torchrun``; the
world size must be ``--num-pods × --num-shards``, and the checkpoint and
the history JSON are byte for byte the one-rank run's (rank 0 writes
them). Ranks that share one card, or run on the CPU, use gloo:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --num-shards 4 --dist-backend gloo \
        --rounds 3 --vocab 10000 --n-users 1000 --clients-per-round 128

The flags are the reference's, with ``--dist-backend`` added.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.core.secret_sharer import make_canaries
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.population_store import MmapPopulationStore
from repro_torch.fl.faults import FaultConfig
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.launch.mesh import BACKENDS, init_distributed
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
    ap.add_argument("--inject-canaries", action="store_true",
                    help="add the paper's secret-sharing synthetic devices "
                         "(27 canaries, 189 devices)")
    ap.add_argument("--backend", default="engine",
                    choices=["engine", "engine_python", "host"],
                    help="engine = the simulation engine, everything on the "
                         "device (repro_torch.fl.engine); engine_python = "
                         "the same read after every round; host = numpy "
                         "sampling and batching, round body on the device")
    ap.add_argument("--rounds-per-call", type=int, default=10,
                    help="rounds between host reads (engine backend)")
    ap.add_argument("--num-shards", type=int, default=1,
                    help="shard the per-round cohort axis across this many "
                         "ranks per pod (engine backend; one process a "
                         "rank, started by torchrun --nproc-per-node "
                         "num_pods x num_shards)")
    ap.add_argument("--num-pods", type=int, default=1,
                    help="lay the cohort shards out over this many pods — "
                         "the 2-D (pod, data) batch slice of the production "
                         "mesh; needs num_pods x num_shards ranks (engine "
                         "backend)")
    ap.add_argument("--dist-backend", default="nccl", choices=BACKENDS,
                    help="torch.distributed backend of the ranks: nccl "
                         "(one card a rank) or gloo (ranks that share a "
                         "card, or run on the CPU); never switched "
                         "quietly")
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
    ap.add_argument("--population-backend", default=None,
                    choices=["device", "streamed"],
                    help="device = the whole padded corpus on the device; "
                         "streamed = the corpus stays on the host and one "
                         "cohort is staged a round (engine backends; "
                         "bitwise the device backend's run)")
    ap.add_argument("--population-store", default=None, metavar="DIR",
                    help="an on-disk population store (python -m "
                         "repro_torch.launch.build_corpus): replaces the "
                         "synthesized dataset and implies "
                         "--population-backend streamed unless given")
    ap.add_argument("--sampler", default="global",
                    choices=["global", "sharded"],
                    help="cohort selection (engine backends): global = "
                         "torch.multinomial over the population; sharded = "
                         "the block-keyed Gumbel top-k of "
                         "repro_torch.fl.pop_sampler")
    ap.add_argument("--availability", type=float, default=0.3,
                    help="per-round device check-in probability; keep "
                         "availability·n_users above clients_per_round")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--fault-dropout", type=float, default=0.0,
                    help="per-selected-client dropout probability (accepts "
                         "the task, never reports); any fault flag > 0 "
                         "enables the over-selection/report-goal round "
                         "protocol (engine backend)")
    ap.add_argument("--fault-straggler", type=float, default=0.0,
                    help="fraction of selected clients whose report latency "
                         "is Exponential(--fault-straggler-delay)")
    ap.add_argument("--fault-straggler-delay", type=float, default=1.0,
                    help="mean straggler report latency (same units as "
                         "--fault-deadline)")
    ap.add_argument("--fault-deadline", type=float, default=3.0,
                    help="round deadline; straggler reports past it are "
                         "dropped from the round")
    ap.add_argument("--fault-corrupt", type=float, default=0.0,
                    help="probability a delivered report is non-finite "
                         "garbage (rejected by the server-side guard)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the fault stream (disjoint from --seed's "
                         "training generator)")
    ap.add_argument("--report-goal", type=int, default=None,
                    help="minimum usable reports for a round to commit; "
                         "rounds below it abort (no server step, no privacy "
                         "spend). Default: ceil(0.8 x clients_per_round) "
                         "when faults are on")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the run state every N rounds (engine "
                         "backend); 0 = only the final checkpoint")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the run-state snapshot in --out if "
                         "one exists; the finished run is bitwise an "
                         "uninterrupted one")
    ap.add_argument("--crash-after", type=int, default=None,
                    help="simulate a crash: exit (skipping the final "
                         "checkpoint) once this many rounds are done — for "
                         "exercising --resume")
    args = ap.parse_args(argv)
    ranks = args.num_pods * args.num_shards
    if ranks > 1 and args.backend == "host":
        ap.error("--num-shards/--num-pods need an engine backend (the host "
                 "loop stacks clients on one host)")
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != ranks:
        ap.error(f"--num-pods {args.num_pods} x --num-shards "
                 f"{args.num_shards} = {ranks} rank(s), but {world} "
                 f"running: launch with python -m torch.distributed.run "
                 f"(torchrun) --nproc-per-node {ranks} -m "
                 "repro_torch.launch.train ...")
    population_backend = args.population_backend or (
        "streamed" if args.population_store is not None else "device")
    if args.population_store is not None and args.inject_canaries:
        ap.error("--inject-canaries builds synthetic devices into a "
                 "dataset; bake them into the store instead "
                 "(python -m repro_torch.launch.build_corpus "
                 "--inject-canaries)")
    if args.backend == "host" and population_backend == "streamed":
        ap.error("--population-backend streamed needs an engine backend "
                 "(the host loop reads the dataset directly)")
    if args.backend == "host" and args.sampler != "global":
        ap.error("--sampler sharded needs an engine backend (the host loop "
                 "samples through PopulationSim)")
    faults = None
    if (args.fault_dropout > 0 or args.fault_straggler > 0
            or args.fault_corrupt > 0 or args.report_goal is not None):
        faults = FaultConfig(seed=args.fault_seed,
                             dropout_prob=args.fault_dropout,
                             straggler_prob=args.fault_straggler,
                             straggler_mean_delay=args.fault_straggler_delay,
                             round_deadline=args.fault_deadline,
                             corrupt_prob=args.fault_corrupt,
                             report_goal=args.report_goal)
    if args.backend == "host" and (faults is not None or args.resume
                                   or args.checkpoint_every > 0
                                   or args.crash_after is not None):
        ap.error("--fault-*/--report-goal/--checkpoint-every/--resume/"
                 "--crash-after need the engine backend (the fault protocol "
                 "and the run state live in the engine)")

    if ranks == 1:
        return _train(args, args.device, population_backend, faults, True)
    # every rank trains; rank 0 alone prints and writes
    device = init_distributed(args.dist_backend, args.device)
    lead = torch.distributed.get_rank() == 0
    try:
        with (contextlib.nullcontext() if lead
              else contextlib.redirect_stdout(io.StringIO())):
            return _train(args, device, population_backend, faults, lead)
    finally:
        torch.distributed.destroy_process_group()


def _train(args, device, population_backend, faults, lead: bool):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "lstm":
        cfg = cfg.with_(vocab=args.vocab)
    if args.cell_path is not None:
        cfg = cfg.with_(cell_path=args.cell_path)
    model = build(cfg)

    store = ds = None
    if args.population_store is not None:
        store = MmapPopulationStore(args.population_store)
        n_users = store.n_users
        synth_ids = np.nonzero(store.synthetic)[0].tolist()
        print(f"population store: {args.population_store} "
              f"({n_users} users, E_max={store.emax}, "
              f"seq_len={store.row_len - 1}, {len(synth_ids)} synthetic)")
    else:
        corpus = BigramCorpus(vocab_size=cfg.vocab, seed=args.seed)
        ds = FederatedDataset(corpus, n_users=args.n_users,
                              seq_len=args.seq_len, sentences_per_user=30)
        if args.inject_canaries:
            canaries = make_canaries(torch.Generator().manual_seed(42),
                                     vocab=cfg.vocab)
            ds.inject_canaries(canaries)
            print(f"injected {len(canaries)} canaries "
                  f"({sum(c.n_u for c in canaries)} synthetic devices)")
        n_users = len(ds.users)
        synth_ids = [u.user_id for u in ds.users if u.is_synthetic]
    dp = DPConfig(clients_per_round=args.clients_per_round,
                  noise_multiplier=args.noise_multiplier,
                  clip_norm=args.clip_norm, server_opt=args.server_opt,
                  server_lr=args.server_lr,
                  server_momentum=args.server_momentum)
    cl = ClientConfig(local_epochs=args.local_epochs,
                      batch_size=args.client_batch, lr=args.client_lr)
    pop = PopulationSim(n_users, availability=args.availability,
                        synthetic_ids=synth_ids, seed=args.seed)
    trainer = FederatedTrainer(model, ds, dp, cl, pop=pop, seed=args.seed,
                               n_local_batches=3, backend=args.backend,
                               rounds_per_call=args.rounds_per_call,
                               cohort_chunk=args.cohort_chunk,
                               clip_path=args.clip_path,
                               population_backend=population_backend,
                               population_store=store, sampler=args.sampler,
                               num_shards=args.num_shards,
                               num_pods=args.num_pods,
                               fault_config=faults, device=device)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    log_every = max(1, args.rounds // 20)
    state_path = out / f"{args.arch}_r{args.rounds}_state.msgpack"
    done = 0
    if args.resume and state_path.exists():
        done = trainer.restore_run_state(state_path)
        print(f"resumed from {state_path} at round {done}")
    chunk = args.checkpoint_every if args.checkpoint_every > 0 \
        else args.rounds
    while done < args.rounds:
        k = min(chunk - done % chunk, args.rounds - done)
        if args.crash_after is not None:
            k = min(k, args.crash_after - done)
        trainer.train(k, log_every=log_every)
        done += k
        if args.checkpoint_every > 0 and done % args.checkpoint_every == 0 \
                and done < args.rounds:
            trainer.save_run_state(state_path)
        if args.crash_after is not None and done >= args.crash_after:
            print(f"simulated crash after round {done} "
                  f"(resume with --resume)")
            return None

    committed = sum(r.get("committed", True)
                    for r in trainer.state.history)
    eps = trainer.accountant.get_epsilon(1e-6)
    print(f"RDP accountant after {args.rounds} rounds "
          f"({committed} committed): eps={eps:.2f} at delta=1e-6 "
          f"(q={trainer.accountant.q:.4f})")

    ck = out / f"{args.arch}_r{args.rounds}.msgpack"
    if not lead:
        return ck
    checkpoint.save(ck, trainer.state.params,
                    meta={"arch": args.arch, "rounds": str(args.rounds),
                          "eps@1e-6": f"{eps:.3f}"})
    (out / f"{args.arch}_r{args.rounds}_history.json").write_text(
        json.dumps(trainer.state.history[-50:], indent=1))
    print(f"checkpoint: {ck}")
    return ck


if __name__ == "__main__":
    main()
