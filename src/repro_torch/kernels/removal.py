"""Removal builds: where the time of a kernel's call goes.

A kernel's source compiles one of its parts out under a ``-D`` switch
(``cifg_cell_fwd.cu``: ``CIFG_SKIP_PRODUCT``, ``CIFG_SKIP_GATES``,
``CIFG_SKIP_EXCHANGE``, ``CIFG_SKIP_BARRIER``; ``cifg_cell_bwd.cu``'s
sequence kernel: ``CIFGB_SKIP_ELEMENTWISE``, ``CIFGB_SKIP_EXCHANGE``,
``CIFGB_SKIP_BARRIER``, ``CIFGB_SKIP_PRODUCT``; ``ssd_scan.cu``:
``SSD_SKIP_CB``, ``SSD_SKIP_INTRA``, ``SSD_SKIP_INTER``). This script builds
each library once as it is and once per switch (one ``nvcc`` each, all
started together, into ``build/kernels/removal/``), and times every build at
a main-path shape with CUDA-graph replays, in turns (the full build, each
removal, then the same again in reverse order), in one process on one card;
the cell kernels' wide route (H 264 and 520) is timed whole, twice.
A removal build's results are wrong; only its time counts. What a part
costs is the full build's time less the time without it.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    PYTHONPATH=src python -m repro_torch.kernels.removal [--out FILE.json]

It prints the card's name and power limit, one line per shape and build,
and writes the same numbers as JSON to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build

# library → (its switches, each with what it removes)
SWITCHES = {
    "cifg_cell_fwd": {
        "CIFG_SKIP_PRODUCT": "the product h·w_h",
        "CIFG_SKIP_GATES": "the gate math",
        "CIFG_SKIP_EXCHANGE": "the stores of h' to the peers",
        "CIFG_SKIP_BARRIER": "the cluster barrier",
    },
    "cifg_cell_bwd": {
        "CIFGB_SKIP_ELEMENTWISE": "the elementwise reverse step",
        "CIFGB_SKIP_EXCHANGE": "the stores of dz to the peers",
        "CIFGB_SKIP_BARRIER": "the cluster barrier",
        "CIFGB_SKIP_PRODUCT": "the product dz·w_hᵀ",
    },
    "ssd_scan": {
        "SSD_SKIP_CB": "C·Bᵀ",
        "SSD_SKIP_INTRA": "W·x",
        "SSD_SKIP_INTER": "C·state",
    },
}


def _library(name: str, define: str | None) -> Path:
    src = build.source_path(name)
    flags = list(build.NVCC_FLAGS) + ([f"-D{define}"] if define else [])
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return (build.BUILD_DIR / "removal"
            / f"lib{name}-{define or 'full'}-{digest}.so")


def build_all() -> dict:
    """Every library of ``SWITCHES``, as it is and once per switch → loaded
    ``ctypes.CDLL`` by (library, switch or None). Raises on a failed
    compile."""
    jobs = {}
    for name, switches in SWITCHES.items():
        for define in (None, *switches):
            path = _library(name, define)
            if path.is_file():
                jobs[(name, define)] = (path, None)
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            cmd = [build.nvcc(), *build.NVCC_FLAGS,
                   *([f"-D{define}"] if define else []), "-o", str(path),
                   str(build.source_path(name))]
            jobs[(name, define)] = (path, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for key, (path, proc) in jobs.items():
        if proc is not None:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                path.unlink(missing_ok=True)
                failed.append(f"{key}: {log}")
    if failed:
        raise RuntimeError("removal build failed:\n" + "\n".join(failed))
    return {key: ctypes.CDLL(str(path)) for key, (path, _) in jobs.items()}


def _graph_ms(fn, per_graph: int = 20, replays: int = 20) -> float:
    """Device time of one ``fn()``: ``per_graph`` calls in one CUDA graph,
    replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _cell_call(lib, B: int, S: int, H: int, gen):
    """One call of ``cifg_cell_seq_fwd`` at (S, B, H), bf16 w_h, one
    client."""
    dev = torch.device("cuda")
    zx = torch.randn((S, B, 3 * H), generator=gen).to(dev)
    h0, c0 = ((0.3 * torch.randn((B, H), generator=gen)).to(dev)
              for _ in range(2))
    w = (torch.randn((H, 3 * H), generator=gen) * H ** -0.5).to(
        dev, torch.bfloat16)
    hs, cs = (torch.empty((S, B, H), device=dev) for _ in range(2))
    fn = lib.cifg_cell_seq_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, p, p, i, i, i, i, p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(zx.data_ptr(), h0.data_ptr(), c0.data_ptr(), w.data_ptr(), 1,
                 0, hs.data_ptr(), cs.data_ptr(), 1, S, B, H, _stream())
        if err:
            raise RuntimeError(f"cifg_cell_seq_fwd failed: CUDA error {err}")
    return call


def _bwd_seq_call(lib, B: int, S: int, H: int, gen):
    """One call of ``cifg_cell_bwd_seq`` at (S, B, H), all float32, one
    client."""
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    z, w = randn(S, B, 3 * H), randn(H, 3 * H, scale=H ** -0.5)
    cs, dhs = randn(S, B, H, scale=0.3), randn(S, B, H, scale=0.1)
    c0, dhf, dcf = (randn(B, H, scale=0.1) for _ in range(3))
    dz = torch.empty_like(z)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    fn = lib.cifg_cell_bwd_seq
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i] * 4 + [p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(z.data_ptr(), cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
                 dhf.data_ptr(), dcf.data_ptr(), w.data_ptr(), dz.data_ptr(),
                 dh0.data_ptr(), dc0.data_ptr(), 1, S, B, H, _stream())
        if err:
            raise RuntimeError(f"cifg_cell_bwd_seq failed: CUDA error {err}")
    return call


def _ssd_call(lib, B: int, S: int, H: int, P: int, N: int, gen):
    """One call of ``ssd_scan_fwd`` at (B, S, H, p, N), bf16 x, B and C."""
    dev = torch.device("cuda")
    x = torch.randn((B, S, H, P), generator=gen).to(dev, torch.bfloat16)
    dt = (torch.nn.functional.softplus(torch.randn((B, S, H), generator=gen))
          * 0.1).to(dev)
    Bm, Cm = (torch.randn((B, S, N), generator=gen).to(dev, torch.bfloat16)
              for _ in range(2))
    A = (-torch.exp(torch.randn((H,), generator=gen))).to(dev)
    y = torch.empty((B, S, H, P), device=dev)
    state = torch.empty((B, H, P, N), device=dev)
    chunk_states = torch.empty((B, S // 128, H, P, N), device=dev)
    decay = torch.empty((B, S // 128, H), device=dev)
    fn = lib.ssd_scan_fwd
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 7 + [p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), y.data_ptr(), state.data_ptr(),
                 chunk_states.data_ptr(), decay.data_ptr(), 1, B, S, H, P, N,
                 0, _stream())
        if err:
            raise RuntimeError(f"ssd_scan_fwd failed: CUDA error {err}")
    return call


# (library, label, call maker): the main-path shapes, each build timed
SHAPES = [
    ("cifg_cell_fwd", "bf16 B=10 S=16 H=256 (a training client batch)",
     lambda lib, gen: _cell_call(lib, 10, 16, 256, gen)),
    ("cifg_cell_fwd", "bf16 B=256 S=1 H=256 (a decode tick)",
     lambda lib, gen: _cell_call(lib, 256, 1, 256, gen)),
    ("cifg_cell_bwd", "f32 B=10 S=16 H=256 (a training client batch's "
     "reverse recursion)",
     lambda lib, gen: _bwd_seq_call(lib, 10, 16, 256, gen)),
    ("ssd_scan", "bf16 inputs B=4 S=512 H=80 p=64 N=64 (zamba2-2.7b prefill)",
     lambda lib, gen: _ssd_call(lib, 4, 512, 80, 64, 64, gen)),
]
# the cell kernels' wide route (H > 256), whose kernels have no switches:
# the full build only
WHOLE = [
    (name, f"{what} B=10 S=16 H={H} (the wide route)",
     lambda lib, gen, call=call, H=H: call(lib, 10, 16, H, gen))
    for H in (264, 520)
    for name, what, call in (("cifg_cell_fwd", "bf16", _cell_call),
                             ("cifg_cell_bwd", "f32", _bwd_seq_call))
]


def run(out: str | None = None) -> list:
    if not torch.cuda.is_available():
        raise SystemExit("removal: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    libs = build_all()
    rows = []
    for (name, label, make), split in ([(s, True) for s in SHAPES]
                                       + [(s, False) for s in WHOLE]):
        order = [None, *SWITCHES[name]] if split else [None]
        calls = {d: make(libs[(name, d)], torch.Generator().manual_seed(7))
                 for d in order}
        times = {d: [] for d in order}
        for d in order + order[::-1]:       # in turns, then in reverse
            times[d].append(_graph_ms(calls[d]) * 1e3)
        full = sum(times[None]) / 2
        parts = []
        for d in order[1:]:
            t = sum(times[d]) / 2
            parts.append(f"without {SWITCHES[name][d]} "
                         f"{times[d][0]:.2f}/{times[d][1]:.2f} us "
                         f"(it costs {full - t:.2f})")
        print(f"removal: {name} {label}: full build "
              f"{times[None][0]:.2f}/{times[None][1]:.2f} us"
              + "".join(f"; {p}" for p in parts), flush=True)
        rows.append({"kernel": name, "shape": label, "card": card.strip(),
                     "us": {d or "full": v for d, v in times.items()}})
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(rows, indent=1))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the times as JSON here")
    run(ap.parse_args().out)


if __name__ == "__main__":
    main()
