"""The Secret Sharer's Random-Sampling sweep through the port's
``core.secret_sharer.random_sampling_ranks``: the memorization cells.

Set-up makes the weights (in the serving form, with the compute copies the
port derives) and the canaries on the card from the seed, and scores one
small pass whose pool holds one whole chunk and one of the last chunk's
size, so every shape of the window is warm. The window runs whole passes,
one after another: each draws its pool of |R| continuations on the card
from the seed and the pass's number, and scores it behind every canary in
chunks, to its (K,) ranks.

The check samples, from the seed, one pass and ``check.canaries`` of the
canaries, scores that pass's pool behind each in the plain reference, and
measures how far each rank the program gave lies from the reference's
scores (`harness.compare.rank_gap`).
"""
from __future__ import annotations

import random
import time

import torch

from port_bench.harness import compare as C
from port_bench.harness import env
from port_bench.harness import trace as TR
from port_bench.reference import lstm as RL
from port_bench.reference.precision import exact_matmul
from port_bench.traffic import canaries as TC

REF_BLOCK = 16384


class Program:
    """The model, its parameters and canaries, the set-up's parts, and the
    passes' ranks."""


def weights(cell, seed: int, dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(env.subseed(seed, "weights"))
    return RL.init(cell.config["model"], cell.workload["init"], g)


def canary_tokens(cell, seed: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(
        env.subseed(seed, "canaries"))
    return TC.canaries(cell.traffic, cell.config["model"]["vocab"], g)


def pool(cell, seed: int, p: int, dev) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(env.subseed(seed, f"pool{p}"))
    return TC.pool(cell.traffic, cell.config["model"]["vocab"], g)


def setup(cell, seed: int, dev) -> Program:
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import secret_sharer as ss
    from repro_torch.models.registry import build
    from repro_torch.utils.params import with_compute_copies

    mix = cell.traffic
    prog, parts = Program(), {}
    prog.cell, prog.dev, prog.seed, prog.excluded_s = cell, dev, seed, 0.0
    t = time.perf_counter()
    prog.model = build(ModelConfig(**cell.config["model"]))
    prog.params = with_compute_copies(weights(cell, seed, dev),
                                      prog.model.cfg.compute_dtype,
                                      prog.model.compute_copies)
    TR.sync()
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    toks = canary_tokens(cell, seed, dev)
    prog.canaries = [ss.Canary(tuple(row), 1, 1) for row in toks.tolist()]
    prog.rank_fn = ss.random_sampling_ranks
    rem = mix["pool"] % mix["chunk"]
    g = torch.Generator(device=dev).manual_seed(env.subseed(seed, "warm"))
    warm = torch.randint(0, cell.config["model"]["vocab"],
                         (mix["chunk"] + rem, toks.shape[1] - mix["prefix_len"]),
                         generator=g, device=dev)
    prog.rank_fn(prog.model, prog.params, prog.canaries, continuations=warm,
                 batch_size=mix["chunk"])
    TR.sync()
    parts["canaries_and_warm_pass_s"] = time.perf_counter() - t
    prog.parts = parts
    prog.readings = {"ranks": []}
    return prog


def _ranks(prog, conts):
    return prog.rank_fn(prog.model, prog.params, prog.canaries,
                        continuations=conts,
                        batch_size=prog.cell.traffic["chunk"])


def window(prog, seconds: float, trace: bool) -> dict:
    """Whole passes until ``seconds`` have passed. Traced, one pass: its
    first ``trace_chunks`` chunks are scored by one call under the
    profiler (the traced window) and the rest by a second call, the two
    calls' ranks added (a rank is a count over the pool's chunks). A pass
    launches some 1,700 kernels a chunk, and the profiler's trace of a
    whole pass would take minutes to reduce."""
    cell, mix = prog.cell, prog.cell.traffic
    ranks = prog.readings["ranks"]
    if trace:
        conts = pool(cell, prog.seed, 0, prog.dev)
        head = mix["chunk"] * cell.workload["trace_chunks"]
        with TR.Window(True, cell.workload["trace_host_ops"]) as w:
            first = _ranks(prog, conts[:head])
        rest = _ranks(prog, conts[head:])
        ranks.append([int(a + b) for a, b in zip(first, rest)])
        return {"seconds": w.seconds, "trace": w.data, "attempted": 1,
                "failed": 0, "calls": 1, "per_call": head, "rate": None}
    with TR.Window(False) as w:
        while True:
            conts = pool(cell, prog.seed, len(ranks), prog.dev)
            ranks.append([int(r) for r in _ranks(prog, conts)])
            if w.elapsed() >= seconds:
                break
    seqs = len(ranks) * len(prog.canaries) * mix["pool"]
    return {"seconds": w.seconds, "trace": None, "attempted": len(ranks),
            "failed": 0, "calls": len(ranks), "per_call": mix["pool"],
            "rate": seqs / w.seconds}


def context(prog, win: dict) -> dict:
    """The forward launches of the (traced) window by shape (a call: the
    canaries' scoring, the whole chunks and the last chunk), the chunks of
    ``chunk`` continuations it scored, and the FLOPs scoring needs."""
    cell, mix = prog.cell, prog.cell.traffic
    model, K = cell.config["model"], len(prog.canaries)
    L, n = mix["canary_len"], win["calls"]
    full, rem = divmod(win["per_call"], mix["chunk"])
    shape = {"C": 1, "S": L, "H": model["d_ff"]}
    work = [(dict(shape, B=K), n), (dict(shape, B=K * mix["chunk"]), n * full)]
    if rem:
        work.append((dict(shape, B=K * rem), n))
    seqs = n * K * win["per_call"]
    return {"work": {"cifg_cell_fwd": work},
            "chunks": n * win["per_call"] / mix["chunk"],
            "flops": seqs * RL.score_flops_per_sequence(model, L,
                                                        mix["prefix_len"])}


def release(prog) -> None:
    prog.model = prog.params = None


def sample(cell, seed: int, readings: dict):
    """(pass, canaries) the check scores again, drawn from the seed."""
    rng = random.Random(env.subseed(seed, "check"))
    n_pass = len(readings["ranks"])
    return (rng.randrange(n_pass),
            sorted(rng.sample(range(cell.traffic["n_canaries"]),
                              cell.workload["check"]["canaries"])))


def reference(cell, seed: int, dev, prec: str = "float32", fault=None,
              pick=None) -> dict:
    """The sampled canaries' scores and the sorted scores of the sampled
    pass's pool behind each, in the plain reference."""
    mix, model = cell.traffic, cell.config["model"]
    p, ks = pick
    params = weights(cell, seed, dev)
    toks = canary_tokens(cell, seed, dev)
    conts = pool(cell, seed, p, dev)
    P = mix["prefix_len"]
    out = {"pass": p, "canaries": ks, "canary": [], "pool_sorted": [],
           "ranks": []}
    with torch.no_grad(), exact_matmul():
        for k in ks:
            s_c = float(RL.scores(params, toks[k:k + 1], P, prec)[0])
            pre = toks[k, :P].expand(conts.shape[0], P)
            seqs = torch.cat([pre, conts], 1)
            s = torch.cat([RL.scores(params, seqs[i:i + REF_BLOCK], P, prec)
                           for i in range(0, seqs.shape[0], REF_BLOCK)])
            out["canary"].append(s_c)
            out["pool_sorted"].append(torch.sort(s).values)
            out["ranks"].append(int((s < s_c).sum()))
    return out


def as_readings(ref: dict) -> dict:
    """A reference's ranks where the program's go (only the sampled pass
    and canaries)."""
    return {"ranks": {ref["pass"]: dict(zip(ref["canaries"], ref["ranks"]))}}


def compare(cell, readings: dict, ref: dict) -> dict:
    """``rank_gap``: the widest, over the sampled canaries, of the least
    shift of the reference's canary score that gives the program's rank,
    over the pool scores' interquartile range."""
    ranks = readings["ranks"]
    row = ranks[ref["pass"]]
    worst = 0.0
    for i, k in enumerate(ref["canaries"]):
        worst = max(worst, C.rank_gap(int(row[k]), ref["canary"][i],
                                      ref["pool_sorted"][i]))
    return {"rank_gap": worst}
