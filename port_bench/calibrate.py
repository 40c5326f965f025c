#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card, in one
process.

    python3 port_bench/calibrate.py --workload <cell> --seeds a,b,... \
        [--controls c,d,e] [--faults f,g,h] [--out FILE]

For each of ``--seeds``, the program as a run builds it (set-up and, for a
cell whose readings come from the window, the shortest window: one round
or one pass) against the plain reference: the lower readings. For each of
``--controls``, the control, the reference computed in float8 in the
program's place, against the float32 reference: the upper readings. For
each of ``--faults`` (training cells), each planted fault of
`reference.fedavg.FAULTS` against the float32 reference. The memorization
cell compares every canary here, where a run samples some. One JSON line a
reading goes to standard output and to ``--out``.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--controls", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from port_bench.harness import env
    env.prepare()
    import torch

    from port_bench.harness import manifest
    from port_bench.reference.fedavg import FAULTS
    from repro_torch.kernels import build

    cell = manifest.cell(args.workload)
    drv = manifest.driver(cell.workload)
    build.build()
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    def every(readings):
        pick = drv.sample(cell, seed, readings)
        if pick is None:
            return None
        return (pick[0], list(range(cell.traffic["n_canaries"])))

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    for seed in _seeds(args.seeds):
        t = time.perf_counter()
        prog = drv.setup(cell, seed, dev)
        if not prog.readings.get("loss"):
            drv.window(prog, 0.0, False)
        readings = prog.readings
        drv.release(prog)
        del prog
        free()
        ref = drv.reference(cell, seed, dev, pick=every(readings))
        rec = {"kind": "program", "seed": seed,
               **drv.compare(cell, readings, ref)}
        for k in ("loss", "mean_update_norm"):
            if k in readings:
                rec[k] = readings[k]
                rec["ref_" + k] = ref[k]
        rec["seconds"] = time.perf_counter() - t
        emit(rec)
        del ref, readings
        free()
    for kind, seeds in (("control", _seeds(args.controls)),
                        ("fault", _seeds(args.faults))):
        for seed in seeds:
            pick = ((0, list(range(cell.traffic["n_canaries"])))
                    if "n_canaries" in cell.traffic else None)
            ref = drv.reference(cell, seed, dev, pick=pick)
            runs = ([("control", dict(prec="float8"))] if kind == "control"
                    else [(f"fault:{f}", dict(fault=f)) for f in FAULTS])
            for name, kw in runs:
                t = time.perf_counter()
                other = drv.reference(cell, seed, dev, pick=pick, **kw)
                emit({"kind": name, "seed": seed,
                      **drv.compare(cell, drv.as_readings(other), ref),
                      "seconds": time.perf_counter() - t})
                del other
                free()
            del ref
            free()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
