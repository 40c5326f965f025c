"""The run's refusals, and the reduction of a trace to the per-layer
metrics."""
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from port_bench.harness import manifest as M
from port_bench.harness import readers as R
from port_bench.harness.trace import TraceData, reduce_events

ARGS = ["--workload", "lstm-fedavg", "--seed", str(2 ** 31 + 9),
        "--seconds", "1", "--trace", "0"]


def _run(root):
    return subprocess.run([sys.executable, str(root / "port_bench/run.py"),
                           *ARGS], cwd=root, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: this test is of a machine without one")


def test_no_card_no_result(no_card):
    out = _run(M.ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout and out.stdout.strip() == ""


def test_benchmark_files_alone_no_result(tmp_path):
    shutil.copy(M.MANIFEST, tmp_path / "BENCHMARK.json")
    shutil.copytree(M.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def _ev(name, start, dur, dev):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: dev)


def test_reduce_events():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _ev("aten::mm", 0, 100, cpu),
        _ev("aten::sync", 120, 40, cpu),
        _ev("k_a", 10, 20, cuda),
        _ev("k_a", 25, 20, cuda),                   # overlaps the first
        _ev("Memcpy HtoD", 60, 10, cuda),           # busy, not a kernel
        _ev("k_b", 190, 50, cuda),                  # ends past the window
    ]
    t = reduce_events(events, 0, 200)
    assert t.window_s == pytest.approx(200e-9)
    assert t.busy_s == pytest.approx((35 + 10 + 10) * 1e-9)
    assert t.kernels["k_a"] == (2, pytest.approx(40e-9))
    assert t.kernels["k_b"] == (1, pytest.approx(10e-9))
    assert t.launches == 3
    gaps = dict(t.breakdown["idle_gaps"])
    # gaps [0, 10] and [45, 60] inside aten::mm, [70, 190] (its middle 130)
    # inside aten::sync
    assert gaps == {"aten::mm": pytest.approx(25e-9),
                    "aten::sync": pytest.approx(120e-9)}
    assert t.breakdown["device_ops"][0][0] == "k_a"


def _trace(kernels, busy=1.0, window=2.0):
    return TraceData(kernels=kernels, busy_s=busy, window_s=window,
                     breakdown={})


def test_readers():
    work = {"cifg_cell_fwd": [(dict(C=1, S=5, B=27648, H=256), 10)]}
    ok = _trace({"void cifg_seq_kernel<bf16>": (10, 10 * 1.25e-3)})
    ctx = {"trace": ok, "work": work, "rounds": 2, "chunks": 4,
           "flops": 989e12, "window_s": 2.0, "peak_bytes": 2 ** 31}
    assert R.roofline(ctx, "cifg_cell_fwd") == pytest.approx(
        100 * 228.30e-6 / 1.25e-3, rel=1e-3)
    assert R.mfu(ctx) == pytest.approx(50.0)
    assert R.device_idle(ctx) == pytest.approx(50.0)
    assert R.peak_mem(ctx) == 2.0
    assert R.launches_per_round(ctx) == 5.0
    assert R.device_ms_per_chunk(ctx) == pytest.approx(250.0)
    # a count the work does not predict, or no launch: nothing to read
    bad = dict(ctx, trace=_trace({"cifg_seq_kernel": (9, 1e-2)}))
    assert R.roofline(bad, "cifg_cell_fwd") is None
    assert R.roofline(dict(ctx, trace=_trace({})), "cifg_cell_fwd") is None
    assert R.roofline(dict(ctx, trace=None), "cifg_cell_fwd") is None
    assert R.clip_sum_ms_per_round(ctx) is None
    clip = dict(ctx, trace=_trace({"sumsq_stage1": (2, 1e-3),
                                   "clip_accumulate_kernel": (4, 3e-3)}))
    assert R.clip_sum_ms_per_round(clip) == pytest.approx(2.0)


def _stand_in_driver(plant):
    """A driver whose reference loads ``jax``, with a window and a
    comparison that need no card."""
    import torch

    trace = _trace({}, busy=1.0, window=1.0)
    prog = SimpleNamespace(excluded_s=0.0, parts={}, readings={})
    return SimpleNamespace(
        setup=lambda cell, seed, dev: prog,
        window=lambda prog, seconds, traced: {
            "seconds": 1.0, "trace": trace if traced else None,
            "attempted": 1, "failed": 0, "rate": 1.0},
        context=lambda prog, win: {"work": {}, "flops": 1.0, "rounds": 1,
                                   "chunks": 1},
        release=lambda prog: None,
        sample=lambda cell, seed, readings: None,
        reference=lambda cell, seed, dev, pick=None: plant() or {},
        compare=lambda cell, readings, ref: {
            k: 0.0 for k in cell.workload["limits"]},
        as_readings=lambda ref: ref)


@pytest.mark.parametrize("trace", [0, 1])
def test_jax_loaded_after_the_window_no_result(monkeypatch, capsys, trace):
    """A forbidden package that only the reference, the comparison or a
    metric reader loads, after the window, still stops the result."""
    import types

    from port_bench import run
    from port_bench.harness import device as D
    from port_bench.harness import env
    from repro_torch.kernels import build

    # the test process may hold JAX from the repo's other tests
    for name in list(sys.modules):
        if name.split(".", 1)[0] in env.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    planted = []

    def plant():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        planted.append(True)

    monkeypatch.setattr(D, "require", lambda chips: None)
    monkeypatch.setattr(D, "peak_bytes", lambda chips: 0)
    monkeypatch.setattr(D, "describe", lambda chips, peak: {})
    monkeypatch.setattr(D, "power_limit", lambda: "no card")
    monkeypatch.setattr(build, "build", lambda: {})
    monkeypatch.setattr(M, "driver", lambda wl: _stand_in_driver(plant))
    monkeypatch.setattr("torch.cuda.empty_cache", lambda: None)
    rc = run.main([*ARGS[:-1], str(trace)])
    out = capsys.readouterr()
    assert planted and rc == 4
    assert out.out.strip() == "" and "jax" in out.err
