"""The measured window, and with ``--trace 1`` the profiler's trace of it.

`Window` synchronises the card at both ends and times the window on the
host's clock. Traced, it records the CPU's operators and the card's
activity with ``torch.profiler`` (CUPTI) and reduces them to `TraceData`:
each kernel name's launch count and device time inside the window, the
union of every kernel, copy and set on the card (``busy_s``), the
window's length, and the breakdown: the kernels with the most device time
and the longest idle gaps, each labelled by the innermost host operator
that ran across the gap's middle.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

TOP = 10
NAME_CHARS = 96


class TraceData(NamedTuple):
    kernels: Dict[str, Tuple[int, float]]   # name → (launches, seconds)
    busy_s: float
    window_s: float
    breakdown: dict

    def time_of(self, *parts: str) -> Tuple[int, float]:
        """Launches and device seconds of the kernels whose name holds any
        of ``parts``."""
        n, s = 0, 0.0
        for name, (k, t) in self.kernels.items():
            if any(p in name for p in parts):
                n, s = n + k, s + t
        return n, s

    @property
    def launches(self) -> int:
        return sum(k for k, _ in self.kernels.values())


def _kind(e) -> str:
    """"copy" for a device event that copies or sets memory, "kernel" for
    any other."""
    return "copy" if e.name().startswith(("Memcpy", "Memset")) else "kernel"


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_events(events, t0_ns: int, t1_ns: int) -> TraceData:
    """Profiler events → `TraceData` over the window [t0_ns, t1_ns]."""
    from torch.autograd import DeviceType

    kernels = defaultdict(lambda: [0, 0])
    busy, host = [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        end = start + dur
        if e.device_type() == DeviceType.CUDA:
            kind = _kind(e)
            if end <= t0_ns or start >= t1_ns:
                continue
            a, b = max(start, t0_ns), min(end, t1_ns)
            busy.append((a, b))
            if kind == "kernel":
                k = kernels[e.name()]
                k[0] += 1
                k[1] += b - a
        elif dur > 0 and end > t0_ns and start < t1_ns:
            host.append((start, end, e.name()))
    spans = _union(busy)
    busy_ns = sum(b - a for a, b in spans)
    gaps = [(a, b) for (_, a), (b, _) in zip([(t0_ns, t0_ns)] + spans,
                                             spans + [(t1_ns, t1_ns)])
            if b > a]
    host.sort()
    starts = [h[0] for h in host]
    by_label = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        label = "no host operator"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        by_label[label[:NAME_CHARS]] += b - a
    dev_ops = sorted(((n[:NAME_CHARS], v[1] / 1e9)
                      for n, v in kernels.items()), key=lambda x: -x[1])
    idle = sorted(((n, v / 1e9) for n, v in by_label.items()),
                  key=lambda x: -x[1])
    return TraceData(
        kernels={n: (v[0], v[1] / 1e9) for n, v in kernels.items()},
        busy_s=busy_ns / 1e9, window_s=(t1_ns - t0_ns) / 1e9,
        breakdown={"device_ops": [list(x) for x in dev_ops[:TOP]],
                   "idle_gaps": [list(x) for x in idle[:TOP]]})


def sync() -> None:
    """Wait for the card, where there is one."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Window:
    """``with Window(trace) as w:`` … — ``w.seconds`` is the window's host
    time, ``w.data`` its `TraceData` when traced. ``host_ops=False`` records
    the card's activity and the CUDA API calls alone, not every operator
    (for windows of millions of operators, whose trace would take minutes
    to reduce); the idle gaps are then labelled by the API call in flight."""

    def __init__(self, trace: bool, host_ops: bool = True):
        self.trace, self.host_ops = trace, host_ops
        self.data: Optional[TraceData] = None
        self._prof = None

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] if self.host_ops else []
            if torch.cuda.is_available() or not acts:
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        sync()
        self.t0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def __exit__(self, *exc):
        sync()
        self.seconds = time.perf_counter() - self.t0
        t1_ns = time.time_ns()
        if self._prof is not None:
            t = time.perf_counter()
            self._prof.__exit__(*exc)
            if exc[0] is None:
                events = self._prof.profiler.kineto_results.events()
                t_stop = time.perf_counter() - t
                self.data = reduce_events(events, self.t0_ns, t1_ns)
                sys.stderr.write(
                    f"trace: {len(events)} events, the profiler's stop "
                    f"{t_stop:.1f} s, the reduction "
                    f"{time.perf_counter() - t - t_stop:.1f} s\n")
            self._prof = None
        return False
