"""The join of the port's spans with the card's trace
(`harness.span_trace`) and the readers of it (`harness.span_readers`), on
synthetic events and spans, and `SpanWindow` over a CPU window."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from port_bench.harness import span_readers as SR
from port_bench.harness import span_trace as ST
from port_bench.harness import trace as TR
from repro_torch.utils.spans import Span

MAIN, AUTOGRAD = 1, 2


def _span(i, name, a, b, parent=None, thread=MAIN):
    return Span(i, name, a, b, parent, thread, {})


# engine.call ⊃ client.step ⊃ client.grad on the main thread; the
# recomputed backward on the autograd thread, a child of client.grad;
# rowstable_mm inside it; a second round's sample after the step
SPANS = [
    _span(0, "engine.call", 0, 100),
    _span(1, "client.step", 10, 90, 0),
    _span(2, "client.grad", 20, 80, 1),
    _span(3, "recompute.backward", 30, 50, 2, AUTOGRAD),
    _span(4, "rowstable_mm", 40, 45, 3, AUTOGRAD),
    _span(5, "engine.sample", 91, 95, 0),
]
IDLE = [(5, 15), (25, 35), (42, 60), (94, 105)]


def _trace(spans=SPANS, launches=(12, 22, 33, 41, 60, 92, 104),
           counts=None):
    return ST.SpanTrace(0, 110, IDLE, list(spans),
                        counts or {"host_reads": 3},
                        None if launches is None else sorted(launches),
                        len(launches or ()))


def test_idle_split_by_the_innermost_span_across_threads():
    pieces = ST.innermost(SPANS)
    by_id, none = ST.split(IDLE, pieces)
    # [5,15]: call 5, step 5; [25,35]: grad 5, backward 5; [42,60]:
    # rowstable_mm 3, backward 5, grad 10; [94,105]: sample 1, call 5,
    # no span 5
    assert by_id == {0: 5 + 5, 1: 5, 2: 5 + 10, 3: 5 + 5, 4: 3, 5: 1}
    assert none == 5
    assert sum(by_id.values()) + none == sum(b - a for a, b in IDLE)
    # the pieces tile the spans' union, each the latest-started open span
    assert [(a, b, s.name) for a, b, s in pieces] == [
        (0, 10, "engine.call"), (10, 20, "client.step"),
        (20, 30, "client.grad"), (30, 40, "recompute.backward"),
        (40, 45, "rowstable_mm"), (45, 50, "recompute.backward"),
        (50, 80, "client.grad"), (80, 90, "client.step"),
        (90, 91, "engine.call"), (91, 95, "engine.sample"),
        (95, 100, "engine.call")]


def test_launches_placed_by_the_innermost_span():
    by_id, none = ST.place([12, 22, 33, 41, 60, 92, 104],
                           ST.innermost(SPANS))
    assert by_id == {1: 1, 2: 2, 3: 1, 4: 1, 5: 1} and none == 1


def test_under_names_a_span_and_its_descendants():
    assert ST.under(SPANS, "client.step") == {1, 2, 3, 4}
    assert ST.under(SPANS, "rowstable_mm") == {4}
    assert ST.under(SPANS, "absent") == set()


def _ev(name, start, dur, dev, corr=0):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: dev, correlation_id=lambda: corr)


def _events():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    return [
        _ev("aten::mm", 0, 100, cpu, corr=7),        # an op: not a call
        _ev("cudaLaunchKernel", 3, 2, cpu, corr=7),
        _ev("cudaLaunchKernelExC", 20, 2, cpu, corr=8),
        _ev("cudaMemcpyAsync", 50, 2, cpu, corr=9),
        _ev("k_a", 10, 20, cuda, corr=7),
        _ev("k_b", 25, 20, cuda, corr=8),            # overlaps k_a
        _ev("Memcpy HtoD", 60, 10, cuda, corr=9),    # busy, not a kernel
        _ev("k_c", 150, 10, cuda, corr=10),          # no call held
        _ev("k_d", 250, 10, cuda, corr=11),          # past the window
    ]


def test_launches_joined_by_correlation_id():
    launches, kernels = ST.launch_times(_events(), 0, 200)
    assert launches == [3, 20] and kernels == 3
    unlinked = [e for e in _events() if "Launch" not in e.name()]
    assert ST.launch_times(unlinked, 0, 200) == (None, 3)


def test_idle_intervals_are_the_complement_of_busy():
    events = _events()
    t = TR.reduce_events(events, 0, 200)
    idle = ST.idle_intervals(events, 0, 200)
    assert idle == [(0, 10), (45, 60), (70, 150), (160, 200)]
    assert sum(b - a for a, b in idle) == pytest.approx(
        (t.window_s - t.busy_s) * 1e9)


def test_readers():
    st = _trace()
    ctx = {"spans": st, "rounds": 2}
    assert SR.READERS["sample_ms_per_round"](ctx) == pytest.approx(
        4 / 1e6 / 2)
    assert SR.READERS["client_step_ms_per_round"](ctx) == pytest.approx(
        80 / 1e6 / 2)
    assert SR.READERS["host_reads_per_round"](ctx) == 1.5
    # client.step and its descendants: 5 + 15 + 10 + 3 idle ns
    assert SR.READERS["client_step_idle"](ctx) == pytest.approx(
        100.0 * 33 / 110)
    assert SR.READERS["client_step_launches_per_round"](ctx) == 2.5
    assert SR.READERS["rowstable_mm_idle"](ctx) == pytest.approx(
        100.0 * 3 / 110)
    chunks = [_span(i, "rs.chunk", 10 * i, 10 * i + 4) for i in range(3)]
    assert SR.READERS["rs_chunk_host_ms"]({"spans": _trace(chunks)}) \
        == pytest.approx(4e-6)
    # the idle split sums to the idle share less the part under no span
    _, none = ST.split(st.idle, ST.innermost(st.spans))
    by_name = ST.table(st)
    assert sum(r["idle_ms"] for r in by_name.values()) * 1e6 + none \
        == pytest.approx(sum(b - a for a, b in IDLE))
    assert by_name["client.grad"]["calls"] == 1
    assert by_name["client.grad"]["launches"] == 2
    line = ST.spans_line(st)
    assert line.startswith("spans: ") and "unspanned idle" in line


def test_readers_without_spans_read_nothing():
    empty = _trace(spans=[])
    unlinked = _trace(launches=None)
    for name, read in SR.READERS.items():
        assert read({"rounds": 2}) is None, name
        assert read({"spans": None, "rounds": 2}) is None, name
        assert read({"spans": empty, "rounds": 2}) is None, name
    assert SR.READERS["client_step_launches_per_round"](
        {"spans": unlinked, "rounds": 2}) is None
    assert SR.READERS["rs_chunk_host_ms"]({"spans": _trace()}) is None


def test_span_window_keeps_the_trace_it_reduces(monkeypatch):
    """A traced `SpanWindow` on the CPU: its `TraceData` is
    `reduce_events` of the window's own events, as a `trace.Window`'s is,
    and its spans cover the window's work."""
    from repro_torch.utils import spans

    seen = {}
    join = ST.idle_intervals

    def keep(events, t0, t1):
        seen["events"] = list(events)
        return join(events, t0, t1)

    monkeypatch.setattr(ST, "idle_intervals", keep)
    a = torch.randn(128, 128)
    with ST.SpanWindow(True, True) as w:
        with spans.span("client.grad"):
            torch.mm(a, a)
        spans.count("host_reads")
    st = w.spans
    assert w.data == TR.reduce_events(seen["events"], st.t0_ns, st.t1_ns)
    assert st.counts == {"host_reads": 1}
    assert [s.name for s in st.spans] == ["client.grad"]
    assert sum(b - a for a, b in st.idle) == pytest.approx(
        (w.data.window_s - w.data.busy_s) * 1e9)
    with ST.SpanWindow(False) as u:
        with spans.span("client.step"):
            pass
    assert u.spans is None and u.data is None
    assert [s.name for s in u.rec.spans] == ["client.step"]


@pytest.mark.parametrize("name", ["lstm-fedavg", "mamba2-fedavg",
                                  "lstm-memorize"])
def test_probe_on_a_tiny_cell(name):
    """`span_probe.probe` on the CPU: a pair of untraced windows, each
    started from the set-up's readings (a window's rate is its own work
    over its own seconds), then a traced window whose spans cover its idle
    time and feed the cell's readers."""
    from port_bench import span_probe as P
    from port_bench.tests.tiny import one_thread, tiny_cell

    cell = tiny_cell(name)
    # a CPU build of torch has no CUDA activity to trace: the operators are
    # the trace's events there
    cell.workload["trace_host_ops"] = True
    if name == "lstm-memorize":
        cell.workload["trace_chunks"] = 2
    out = []
    with one_thread():
        P.probe(cell, 2 ** 31 + 77, 0.0, 1, "cpu", out.append)
    timed, (traced,) = out[:-1], out[-1:]
    assert [r["recording"] for r in timed] == [False, True]
    # a window of 0 s is one call's work, the same in each window
    assert timed[0]["attempted"] == timed[1]["attempted"]
    work = [r["rate"] * r["seconds"] for r in timed]
    assert work[0] == pytest.approx(work[1], rel=1e-9)
    want = (["rs_chunk_host_ms", "rowstable_mm_idle"]
            if name == "lstm-memorize" else
            ["sample_ms_per_round", "host_reads_per_round",
             "client_step_ms_per_round", "client_step_idle"])
    for key in want:
        assert traced[key] is not None, key
    assert traced["unspanned_idle"] < 5.0
    assert traced["counts"]["host_reads"] >= 1
