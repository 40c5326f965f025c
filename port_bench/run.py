#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the start of this script to the window, less
the copies the check alone needs) imports the port, builds its kernels
into ``build/kernels`` of the checkout (the first run of a checkout), and
hands the cell's driver the seed, which makes the traffic and the
weights on the card and warms every shape the window uses. The window
then measures for ``--seconds``; with ``--trace 1`` under
``torch.profiler``, and the per-layer metrics are reported instead of the
end-to-end ones. After the window the peak of device memory is read, the
program's state is freed, and the plain reference decides ``correct``.

Exit codes: 0 with a result; 3 without the cards the cell needs; 4 when
a JAX package or the JAX reproduction was loaded, as looked for after the
window and again just before the result is printed; 1 on an error. Only
code 0 prints a result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _fmt(x) -> str:
    return repr(float(x)) if isinstance(x, (int, float)) else str(x)


def _holds_forbidden(when: str) -> bool:
    """Whether the process holds a JAX package or the JAX reproduction,
    named on standard error."""
    from port_bench.harness import device as D
    from port_bench.harness import env
    bad = env.forbidden_modules()
    if bad:
        D.say(f"run: the process holds {bad} {when}")
    return bool(bad)


def main(argv=None) -> int:
    args = _args(argv)
    from port_bench.harness import env
    env.prepare()
    from port_bench.harness import compare as C
    from port_bench.harness import device as D
    from port_bench.harness import manifest

    cell = manifest.cell(args.workload)
    import torch
    try:
        D.require(cell.chips)
    except D.NoCard as err:
        D.say(f"run: {err}")
        return 3
    parts = {}
    t = time.perf_counter()
    from repro_torch.kernels import build
    parts["imports_s"] = time.perf_counter() - T_START
    info = build.build()
    parts["kernels_s"] = time.perf_counter() - t
    parts["nvcc_s"] = sum(v["seconds"] for v in info.values())
    drv = manifest.driver(cell.workload)
    dev = torch.device("cuda", 0)
    prog = drv.setup(cell, args.seed, dev)
    setup_s = time.perf_counter() - T_START - prog.excluded_s
    parts.update(prog.parts)
    parts["check_copies_s"] = prog.excluded_s
    D.say("setup: " + ", ".join(f"{k} {_fmt(v)}" for k, v in parts.items())
          + f"; setup_s {_fmt(setup_s)}")
    win = drv.window(prog, args.seconds, bool(args.trace))
    if _holds_forbidden("after the window"):
        return 4
    peak = D.peak_bytes(cell.chips)
    ctx = drv.context(prog, win)
    ctx.update(trace=win["trace"], window_s=win["seconds"], peak_bytes=peak)
    readings = prog.readings
    drv.release(prog)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = drv.reference(cell, args.seed, dev,
                        pick=drv.sample(cell, args.seed, readings))
    checks = drv.compare(cell, readings, ref)
    del ref
    limits = cell.workload["limits"]
    correct = C.judge(checks, limits) and win["failed"] == 0
    D.say(f"check: {_fmt(time.perf_counter() - t)} s")

    metrics = {}
    if args.trace:
        for m in cell.per_layer:
            v = manifest.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, cell.workload["rate_metric"]:
                  win["rate"]}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    device = D.describe(cell.chips, peak)
    if win["trace"] is not None:
        device.update(busy_s=win["trace"].busy_s,
                      window_s=win["trace"].window_s)
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": device}
    if win["trace"] is not None:
        result["breakdown"] = win["trace"].breakdown
    result["card"] = D.power_limit()
    # a number that is not finite (a check that failed outright) is null
    result["checks"] = {k: {"value": checks[k] if math.isfinite(checks[k])
                            else None, "limit": limits[k]} for k in limits}
    D.say(f"window: {_fmt(win['seconds'])} s, {win['attempted']} attempted, "
          f"{win['failed']} failed; card {result['card']}")
    for k in limits:
        v = checks[k]
        D.say(f"check {k}: {_fmt(v) if math.isfinite(v) else v} "
              f"limit {_fmt(limits[k])}")
    # the reference, the comparison and the metric readers ran since
    if _holds_forbidden("before the result"):
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
