"""DP-FedAvg rounds of the port's `SimEngine` (``fl/engine.py``): the
training cells.

Set-up builds the population and the weights on the card from the seed,
the engine on them, and runs the first ``check.rounds`` rounds through
``SimEngine.run``, the window's own call: they warm up every shape of the
window (a call loops one round for any number of rounds), and give the
program's readings (each round's loss and mean pre-clip norm, the server
momentum after round 1, which is round 1's noised mean update, and the
parameters after the last of them). The same engine state then runs whole calls of
``rounds_per_call`` rounds until the window's seconds have passed, ending
on the history read and a synchronise.

The reference (`reference.fedavg`) follows the same first rounds from the
seed after the window. Both sides draw the same noise; the comparison
takes the reference's noise out of the program's momentum and parameters
(its part of the parameters' change follows from the server step, which is
linear in Δ̄), because at σ = zS/qN the noise's norm can be a thousand
times the update's and would hide any fault of the sum.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.harness import compare as C
from port_bench.harness import env
from port_bench.harness import trace as TR
from port_bench.reference import fedavg as RF
from port_bench.reference import tree as T
from port_bench.traffic import population as P

_CLIENT_KEYS = ("local_epochs", "batch_size", "lr", "max_examples_per_user")


class Program:
    """The engine and its state, the set-up's parts, and the readings."""


def weights(cell, seed: int, dev) -> dict:
    model = cell.config["model"]
    g = torch.Generator(device=dev).manual_seed(env.subseed(seed, "weights"))
    return RF.family(model).init(model, cell.workload["init"], g)


def population(cell, seed: int, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(env.subseed(seed, "traffic"))
    return P.population(cell.traffic, cell.config["model"]["vocab"], g)


def tokens_per_round(cell) -> int:
    """Label positions trained a round, pads included: cohort × local
    batches × B × S."""
    wl = cell.workload
    return (wl["dp"]["clients_per_round"] * wl["client"]["n_local_batches"]
            * wl["client"]["batch_size"] * cell.traffic["seq_len"])


def setup(cell, seed: int, dev) -> Program:
    from repro_torch.configs.base import ClientConfig, DPConfig, ModelConfig
    from repro_torch.fl.engine import SimEngine
    from repro_torch.models.registry import build

    wl, eng = cell.workload, cell.workload["engine"]
    prog, parts = Program(), {}
    prog.cell, prog.dev, prog.excluded_s = cell, dev, 0.0
    t = time.perf_counter()
    pop = population(cell, seed, dev)
    TR.sync()
    parts["population_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = weights(cell, seed, dev)
    TR.sync()
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    model = build(ModelConfig(**cell.config["model"]))
    dp = DPConfig(population=cell.traffic["n_users"], **wl["dp"])
    client = ClientConfig(**{k: wl["client"][k] for k in _CLIENT_KEYS})
    prog.engine = SimEngine(
        model, {"examples": pop["examples"], "counts": pop["counts"].cpu(),
                "synthetic": pop["synthetic"].cpu()},
        dp, client, n_local_batches=wl["client"]["n_local_batches"],
        availability=eng["availability"],
        pace_cooldown=eng["pace_cooldown"], pace_penalty=eng["pace_penalty"],
        rounds_per_call=eng["rounds_per_call"],
        cohort_chunk=eng["cohort_chunk"], clip_path=eng["clip_path"],
        population_backend=eng["population_backend"],
        sampler=eng["sampler"], device=dev)
    del pop
    prog.state = prog.engine.init_state(params,
                                        seed=env.subseed(seed, "engine"))
    del params
    TR.sync()
    parts["engine_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rounds = wl["check"]["rounds"]
    prog.state, h1 = prog.engine.run(prog.state, 1)
    t_ex = time.perf_counter()
    m1 = [l.detach().cpu() for l in T.leaves(prog.state.opt_state.momentum)]
    prog.excluded_s += time.perf_counter() - t_ex
    hists = [h1]
    if rounds > 1:
        prog.state, h2 = prog.engine.run(prog.state, rounds - 1)
        hists.append(h2)
    t_ex = time.perf_counter()
    p3 = [l.detach().cpu() for l in T.leaves(prog.state.params)]
    prog.excluded_s += time.perf_counter() - t_ex
    parts["first_rounds_s"] = time.perf_counter() - t - prog.excluded_s
    prog.readings = {
        k: [float(x) for x in np.concatenate([h[k] for h in hists])]
        for k in ("loss", "mean_update_norm")}
    prog.readings.update(m1=m1, p3=p3)
    prog.parts = parts
    return prog


def window(prog, seconds: float, trace: bool) -> dict:
    rpc = prog.cell.workload["engine"]["rounds_per_call"]
    rounds = failed = 0
    with TR.Window(trace, prog.cell.workload["trace_host_ops"]) as w:
        while True:
            prog.state, hist = prog.engine.run(prog.state, rpc)
            rounds += rpc
            failed += int((~np.isfinite(hist["loss"])).sum())
            if w.elapsed() >= seconds:
                break
    return {"seconds": w.seconds, "trace": w.data, "attempted": rounds,
            "failed": failed, "rounds": rounds,
            "rate": rounds * tokens_per_round(prog.cell) / w.seconds}


def _shape(shape: dict, chunk: int, batch: int) -> dict:
    """A launch's shape from the workload file: ``"chunk"`` is the engine's
    resolved chunk, ``"chunk_rows"`` the chunk times the batch size."""
    sub = {"chunk": chunk, "chunk_rows": chunk * batch}
    return {k: sub.get(v, v) if isinstance(v, str) else v
            for k, v in shape.items()}


def context(prog, win: dict) -> dict:
    """What the per-layer readers read: the launches the workload file
    predicts for each kernel (``launches``: per local step of a chunk, at
    the shapes it gives), and the model FLOPs of the trained tokens."""
    cell, eng = prog.cell, prog.engine
    wl = cell.workload
    nb, B = wl["client"]["n_local_batches"], wl["client"]["batch_size"]
    # a fixed round's live chunks: those holding one of its first qN slots
    chunk = eng.cohort_chunk
    steps = win["rounds"] * -(-wl["dp"]["clients_per_round"] // chunk) * nb
    work = {}
    for spec in wl.get("launches", []):
        work.setdefault(spec["kernel"], []).append(
            (_shape(spec["shape"], chunk, B), steps * spec["per_chunk_step"]))
    fam = RF.family(cell.config["model"])
    flops = (win["rounds"] * tokens_per_round(cell)
             * fam.train_flops_per_token(cell.config["model"],
                                         cell.traffic["seq_len"]))
    return {"work": work, "flops": flops, "rounds": win["rounds"]}


def release(prog) -> None:
    prog.engine = prog.state = None


def sample(cell, seed: int, readings: dict):
    """The fedavg check follows the first rounds whole: no sample."""
    return None


def reference(cell, seed: int, dev, prec: str = "float32", fault=None,
              pick=None) -> dict:
    pop = population(cell, seed, dev)
    pop["examples"] = pop["examples"].to(dev)
    params0 = weights(cell, seed, dev)
    out = RF.run_rounds(params0, pop, cell.workload, cell.config["model"],
                        env.subseed(seed, "engine"),
                        cell.workload["check"]["rounds"], prec, fault)
    out["params0"] = params0
    return out


def as_readings(ref: dict) -> dict:
    """A reference's rounds where the program's readings go."""
    return {"loss": ref["loss"],
            "mean_update_norm": ref["mean_update_norm"],
            "m1": [u + n for u, n in zip(T.leaves(ref["update1"]),
                                         T.leaves(ref["noise"][0]))],
            "p3": T.leaves(ref["params"])}


def compare(cell, readings: dict, ref: dict) -> dict:
    """``loss_gap`` and ``norm_gap``: each round's mean client loss and
    mean pre-clip norm, the largest relative gap; ``update_gap``: round
    1's clipped mean (the momentum after it less the noise), by the worst
    leaf; ``change_gap``: the parameters' change over the rounds less the
    noise's part, by the worst leaf; the ``_median_gap`` of each, the
    median leaf's. A cell compares those its limits name."""
    noise1 = T.leaves(ref["noise"][0])
    dev = noise1[0].device
    upd_r = T.leaves(ref["update1"])
    upd_p = [m.to(dev) - n for m, n in zip(readings["m1"], noise1)]
    npart = RF.noise_part(ref["noise"], cell.workload["dp"])
    p0 = T.leaves(ref["params0"])
    ch_p = [p.to(dev) - a - b for p, a, b in zip(readings["p3"], p0, npart)]
    ch_r = [p - a - b for p, a, b in zip(T.leaves(ref["params"]), p0, npart)]
    update, update_median = C.leaf_gaps(upd_p, upd_r, upd_r)
    change, change_median = C.leaf_gaps(ch_p, ch_r, upd_r)
    return {"loss_gap": C.rel_gap(readings["loss"], ref["loss"]),
            "norm_gap": C.rel_gap(readings["mean_update_norm"],
                                  ref["mean_update_norm"]),
            "update_gap": update, "update_median_gap": update_median,
            "change_gap": change, "change_median_gap": change_median}
