"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same files, with the widths, the population, the cohort and the pool made
small. ``compute_dtype`` float32 makes the port's plain path the
reference's arithmetic up to the order of sums."""
from __future__ import annotations

import contextlib
import copy

import torch

from port_bench.harness import env, manifest

SEED = 2 ** 31 + 12345


def tiny_cell(name: str, compute_dtype: str = "float32"):
    env.prepare()
    cell = manifest.cell(name)
    cfg, mix, wl = (copy.deepcopy(cell.config), copy.deepcopy(cell.traffic),
                    copy.deepcopy(cell.workload))
    m = cfg["model"]
    m["compute_dtype"] = compute_dtype
    if m["family"] == "lstm":
        m.update(d_model=16, d_ff=32, vocab=300)
    else:
        m.update(n_layers=1, d_model=32, vocab=300, ssm_state=16,
                 ssm_heads=1, ssm_head_dim=64)
    if mix["kind"] == "rs_sweep":
        mix.update(n_canaries=5, pool=1500, chunk=256)
        wl["check"]["canaries"] = 3
    else:
        mix.update(n_users=64, examples_min=2, examples_max=12)
        if mix["kind"] == "packed":
            mix["seq_len"] = 64
        wl["dp"]["clients_per_round"] = 16
        wl["reference_chunk"] = 4
        wl["engine"]["rounds_per_call"] = 1
        wl["client"].update(batch_size=min(wl["client"]["batch_size"], 4),
                            n_local_batches=min(
                                wl["client"]["n_local_batches"], 2))
    return cell._replace(config=cfg, traffic=mix, workload=wl)


@contextlib.contextmanager
def one_thread():
    """One intra-op thread inside the block: the tiny cells are thousands
    of small operations, which several test workers' thread pools, each as
    wide as the machine, slow a hundredfold."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def run_check(cell, seed: int = SEED, seconds: float = 0.0):
    """The rest of a run on the CPU: set-up, the window, the reference and
    the comparison. Returns (correct, the numbers compared)."""
    from port_bench.harness import compare as C

    drv = manifest.driver(cell.workload)
    with one_thread():
        prog = drv.setup(cell, seed, "cpu")
        win = drv.window(prog, seconds, False)
        readings = prog.readings
        drv.release(prog)
        ref = drv.reference(cell, seed, "cpu",
                            pick=drv.sample(cell, seed, readings))
        checks = drv.compare(cell, readings, ref)
    ok = C.judge(checks, cell.workload["limits"]) and win["failed"] == 0
    return ok, checks
