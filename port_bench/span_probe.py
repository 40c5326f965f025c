#!/usr/bin/env python3
"""The port's spans over one cell's window on the card, and what
recording them costs.

    python3 port_bench/span_probe.py --workload <cell> --seed <n> \
        --seconds <s> [--pairs 6] [--out FILE]

Set-up is the cell's own, as `run.py` makes it. Then ``--pairs`` pairs
of untraced windows, one with the port's recorder entered around it and
one without, the order alternating from pair to pair, each a line with
its rate; then one traced window that records, whose ``spans:`` line goes
to standard error and whose readings of `harness.span_readers.READERS`
make one line, beside the trace's idle share, the idle under no span and
the recorder's own cost (its spans and counts at the cost of one of each,
timed here). The cell's window runs unchanged: `trace.Window` is
`harness.span_trace.SpanWindow` for the windows that record. Nothing is
compared with the reference. One JSON line a window goes to standard
output and to ``--out``.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TIMED = 100_000


def recorder_cost_ns() -> dict:
    """Host ns of one span and of one count inside a recording, and of one
    span outside it, each the mean of ``TIMED``."""
    from repro_torch.utils import spans

    def per(fn):
        t = time.perf_counter_ns()
        for _ in range(TIMED):
            fn()
        return (time.perf_counter_ns() - t) / TIMED

    def one_span():
        with spans.span("probe", round=0):
            pass

    off = per(one_span)
    with spans.recording():
        on = per(one_span)
        counted = per(lambda: spans.count("probe"))
    return {"span_off_ns": off, "span_on_ns": on, "count_on_ns": counted}


def probe(cell, seed: int, seconds: float, pairs: int, dev, emit) -> None:
    from port_bench.harness import manifest
    from port_bench.harness import readers as R
    from port_bench.harness import span_readers as SR
    from port_bench.harness import span_trace as ST
    from port_bench.harness import trace as TR

    drv = manifest.driver(cell.workload)
    prog = drv.setup(cell, seed, dev)
    readings = copy.deepcopy(prog.readings)
    windows = []

    def factory(*args, **kw):
        windows.append(ST.SpanWindow(*args, **kw))
        return windows[-1]

    def window(record: bool, traced: bool) -> dict:
        # every window starts from the set-up's readings, as `run.py`'s
        # one window does: a memorization window counts its passes in them
        prog.readings = copy.deepcopy(readings)
        if not record:
            return drv.window(prog, seconds, traced)
        with mock.patch.object(TR, "Window", factory):
            return drv.window(prog, seconds, traced)

    for i in range(pairs):
        for record in ((False, True) if i % 2 == 0 else (True, False)):
            win = window(record, False)
            emit({"cell": cell.name, "seed": seed, "pair": i,
                  "recording": record, "seconds": win["seconds"],
                  "attempted": win["attempted"], "rate": win["rate"]})
    win = window(True, True)
    w = windows[-1]
    ctx = drv.context(prog, win)
    ctx.update(trace=win["trace"], window_s=win["seconds"], spans=w.spans)
    out = {"cell": cell.name, "seed": seed, "traced": True,
           "seconds": win["seconds"], "rounds": win.get("rounds"),
           "device_idle": R.device_idle(ctx),
           "idle_gaps": win["trace"].breakdown["idle_gaps"]}
    for name, read in SR.READERS.items():
        v = read(ctx)
        if v is not None:
            out[name] = v
    st = w.spans
    if st is not None:
        _, none = ST.split(st.idle, ST.innermost(st.spans))
        cost = recorder_cost_ns()
        n_counts = sum(st.counts.values())
        out.update(unspanned_idle=100.0 * none / st.window_ns,
                   spans=len(st.spans), counts=dict(st.counts),
                   kernels=st.kernels,
                   linked=None if st.launches is None else len(st.launches),
                   table=ST.table(st), **cost,
                   recorder_share=100.0 * (len(st.spans) * cost["span_on_ns"]
                                           + n_counts * cost["count_on_ns"])
                   / st.window_ns)
    emit(out)
    drv.release(prog)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from port_bench.harness import env
    env.prepare()
    import torch

    from port_bench.harness import device as D
    from port_bench.harness import manifest
    from repro_torch.kernels import build

    cell = manifest.cell(args.workload)
    try:
        D.require(cell.chips)
    except D.NoCard as err:
        D.say(f"span_probe: {err}")
        return 3
    build.build()
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    probe(cell, args.seed, args.seconds, args.pairs,
          torch.device("cuda", 0), emit)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
