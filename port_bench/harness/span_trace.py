"""The port's spans and counters over a window, joined with the card's
trace on the host clock.

`SpanWindow` is `trace.Window` with the port's recorder
(`repro_torch.utils.spans.recording`) entered around the window, traced or
not. Traced, it also keeps a `SpanTrace`: the window's idle intervals (no
kernel, copy or set on the card: the complement of the union that
`trace.reduce_events` calls ``busy_s``), the recorded spans and counters,
and the host time at which each kernel of the window was launched (the
start of the CUDA runtime call that shares its correlation id).

Both clocks are ``time.time_ns()``'s: the profiler's events and the spans
share it. At each instant the innermost span is the open span that
started last, on whichever thread (the autograd engine's CUDA backwards
run on a thread of their own while the caller waits), and every idle
nanosecond and every launch is put down to it (`innermost`, `split`,
`place`), and what falls under no span is counted apart.
"""
from __future__ import annotations

import bisect
import heapq
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from port_bench.harness import trace as TR

# the CUDA API calls that launch a kernel (cudaLaunchKernel, cuLaunchKernel,
# cudaGraphLaunch and their variants)
LAUNCH_CALLS = ("LaunchKernel", "LaunchCooperativeKernel", "GraphLaunch")


class SpanTrace(NamedTuple):
    t0_ns: int
    t1_ns: int
    idle: List[Tuple[int, int]]       # sorted, disjoint, inside the window
    spans: list                       # `repro_torch.utils.spans.Span`s
    counts: Dict[str, int]
    launches: Optional[List[int]]     # launch call starts; None: no link
    kernels: int                      # kernels in the window

    @property
    def window_ns(self) -> int:
        return self.t1_ns - self.t0_ns


def idle_intervals(events, t0_ns: int, t1_ns: int) -> List[Tuple[int, int]]:
    """The window's intervals with nothing on the card."""
    from torch.autograd import DeviceType

    busy = []
    for e in events:
        if e.device_type() != DeviceType.CUDA:
            continue
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if b > t0_ns and a < t1_ns:
            busy.append((max(a, t0_ns), min(b, t1_ns)))
    edges = [(t0_ns, t0_ns)] + TR._union(busy) + [(t1_ns, t1_ns)]
    return [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]


def launch_times(events, t0_ns: int, t1_ns: int
                 ) -> Tuple[Optional[List[int]], int]:
    """(the start of each window kernel's launch call, sorted; the number
    of kernels in the window). A kernel whose call the trace does not
    hold is left out; None when no kernel is linked to a call."""
    from torch.autograd import DeviceType

    calls, kernels = {}, []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            end = e.start_ns() + e.duration_ns()
            if (TR._kind(e) == "kernel" and end > t0_ns
                    and e.start_ns() < t1_ns):
                kernels.append(e.correlation_id())
        elif any(c in e.name() for c in LAUNCH_CALLS):
            calls[e.correlation_id()] = e.start_ns()
    got = sorted(calls[c] for c in kernels if c in calls)
    return (got or None), len(kernels)


def innermost(spans) -> List[Tuple[int, int, object]]:
    """``(start, end, span)`` pieces, in order, of the time each span is
    the innermost open span: of those open, the one that started last (of
    two that started together, the one opened last)."""
    order = sorted(spans, key=lambda s: (s.start_ns, s.id))
    bounds = sorted({s.start_ns for s in spans} | {s.end_ns for s in spans})
    heap, out, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(order) and order[i].start_ns <= a:
            s = order[i]
            heapq.heappush(heap, (-s.start_ns, -s.id, s))
            i += 1
        while heap and heap[0][2].end_ns <= a:
            heapq.heappop(heap)
        if not heap:
            continue
        s = heap[0][2]
        if out and out[-1][2] is s and out[-1][1] == a:
            out[-1] = (out[-1][0], b, s)
        else:
            out.append((a, b, s))
    return out


def split(intervals, pieces) -> Tuple[Dict[int, int], int]:
    """Each span id's share of ``intervals`` (sorted, disjoint) by
    `innermost`'s ``pieces``, and the part under no span."""
    out, j, total = defaultdict(int), 0, 0
    for a, b in intervals:
        total += b - a
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            o = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if o > 0:
                out[pieces[k][2].id] += o
            k += 1
    return dict(out), total - sum(out.values())


def place(times, pieces) -> Tuple[Dict[int, int], int]:
    """How many of ``times`` fall in each span id's `innermost` pieces,
    and how many under no span."""
    starts = [p[0] for p in pieces]
    out, none = defaultdict(int), 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < pieces[i][1]:
            out[pieces[i][2].id] += 1
        else:
            none += 1
    return dict(out), none


def under(spans, name: str) -> set:
    """The ids of the spans named ``name`` and of their descendants."""
    by_id = {s.id: s for s in spans}
    memo: Dict[int, bool] = {}

    def inside(i) -> bool:
        if i is None or i not in by_id:
            return False
        if i not in memo:
            s = by_id[i]
            memo[i] = s.name == name or inside(s.parent)
        return memo[i]

    return {s.id for s in spans if inside(s.id)}


def table(st: SpanTrace) -> Dict[str, Dict[str, float]]:
    """By span name: calls, and the host, idle and launches of the time
    each is the innermost span (its self time)."""
    pieces = innermost(st.spans)
    host, _ = split([(p[0], p[1]) for p in pieces], pieces)
    idle, _ = split(st.idle, pieces)
    launches, _ = place(st.launches or [], pieces)
    out = {}
    for s in st.spans:
        row = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0,
                                      "idle_ms": 0.0, "launches": 0})
        row["calls"] += 1
        row["host_ms"] += host.get(s.id, 0) / 1e6
        row["idle_ms"] += idle.get(s.id, 0) / 1e6
        row["launches"] += launches.get(s.id, 0)
    return out


def spans_line(st: SpanTrace) -> str:
    """The ``spans:`` line: each span name's calls, self host ms, self
    idle ms and self launches, then the idle under no span."""
    rows = table(st)
    _, none = split(st.idle, innermost(st.spans))
    parts = [f"{n} {r['calls']} calls {r['host_ms']!r} host ms "
             f"{r['idle_ms']!r} idle ms {r['launches']} launches"
             for n, r in sorted(rows.items(), key=lambda x: -x[1]["host_ms"])]
    linked = "none" if st.launches is None else len(st.launches)
    return ("spans: " + "; ".join(parts)
            + f"; unspanned idle {none / 1e6!r} ms "
            f"({100.0 * none / st.window_ns!r}% of the window); "
            f"kernels {st.kernels}, linked to a launch call {linked}; "
            f"counts {dict(st.counts)}")


class SpanWindow(TR.Window):
    """`trace.Window` with the port's spans and counters recorded over the
    window (``rec``, traced or not); traced, ``spans`` is its `SpanTrace`
    and a ``spans:`` line goes to standard error."""

    def __init__(self, trace: bool, host_ops: bool = True):
        super().__init__(trace, host_ops)
        self.spans: Optional[SpanTrace] = None

    def __enter__(self):
        from repro_torch.utils import spans
        self._recording = spans.recording()
        self.rec = self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        TR.sync()
        self.seconds = time.perf_counter() - self.t0
        t1_ns = time.time_ns()
        self._recording.__exit__(*exc)
        if self._prof is not None:
            t = time.perf_counter()
            self._prof.__exit__(*exc)
            if exc[0] is None:
                events = self._prof.profiler.kineto_results.events()
                t_stop = time.perf_counter() - t
                self.data = TR.reduce_events(events, self.t0_ns, t1_ns)
                launches, kernels = launch_times(events, self.t0_ns, t1_ns)
                self.spans = SpanTrace(
                    self.t0_ns, t1_ns,
                    idle_intervals(events, self.t0_ns, t1_ns),
                    list(self.rec.spans), dict(self.rec.counts), launches,
                    kernels)
                sys.stderr.write(
                    f"trace: {len(events)} events, the profiler's stop "
                    f"{t_stop:.1f} s, the reduction and the join "
                    f"{time.perf_counter() - t - t_stop:.1f} s\n"
                    + spans_line(self.spans) + "\n")
            self._prof = None
        return False
