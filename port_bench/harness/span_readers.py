"""Readers of the port's spans and counters: each takes the run's context
with ``spans``, the window's `span_trace.SpanTrace`, beside ``rounds``
(the training cells), and returns a number, or None when the context holds
no spans to read (a window not recorded, or a program without the span).

Host milliseconds are a span's whole duration, its children's included;
idle shares put each idle nanosecond of the window down to the innermost
span open at that instant (`span_trace.innermost`), and a launch to the
innermost span open when its CUDA call started.

`READERS` names each by the metric it would feed, less the cell's suffix
(``sample_ms_per_round`` is ``sample_ms_per_round.train`` in lstm-fedavg
and ``.zoo_train`` in mamba2-fedavg).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

from port_bench.harness import span_trace as ST


def _spans(ctx, name: str):
    """The window's `SpanTrace` when it holds a span ``name``."""
    st = ctx.get("spans")
    if st is None or not any(s.name == name for s in st.spans):
        return None
    return st


def span_ms_per_round(ctx, name: str) -> Optional[float]:
    """Host ms a round of the spans ``name``."""
    st = _spans(ctx, name)
    if st is None or not ctx.get("rounds"):
        return None
    ns = sum(s.end_ns - s.start_ns for s in st.spans if s.name == name)
    return ns / 1e6 / ctx["rounds"]


def span_ms_per_call(ctx, name: str) -> Optional[float]:
    """Host ms of a span ``name``, the mean over its calls."""
    st = _spans(ctx, name)
    if st is None:
        return None
    ns = [s.end_ns - s.start_ns for s in st.spans if s.name == name]
    return sum(ns) / len(ns) / 1e6


def count_per_round(ctx, name: str, span: str) -> Optional[float]:
    """The counter ``name`` a round, where the window holds ``span``."""
    st = _spans(ctx, span)
    if st is None or not ctx.get("rounds"):
        return None
    return st.counts.get(name, 0) / ctx["rounds"]


def idle_share_under(ctx, name: str) -> Optional[float]:
    """The window's share, in %, with the card idle while the innermost
    span is ``name`` or one of its descendants."""
    st = _spans(ctx, name)
    if st is None or st.window_ns <= 0:
        return None
    ids = ST.under(st.spans, name)
    by_id, _ = ST.split(st.idle, ST.innermost(st.spans))
    return 100.0 * sum(v for i, v in by_id.items() if i in ids) \
        / st.window_ns


def launches_per_round_under(ctx, name: str) -> Optional[float]:
    """Kernels a round whose launch call ran while the innermost span was
    ``name`` or one of its descendants; None when the trace links no
    kernel to its call."""
    st = _spans(ctx, name)
    if st is None or st.launches is None or not ctx.get("rounds"):
        return None
    ids = ST.under(st.spans, name)
    by_id, _ = ST.place(st.launches, ST.innermost(st.spans))
    return sum(v for i, v in by_id.items() if i in ids) / ctx["rounds"]


READERS = {
    "sample_ms_per_round": partial(span_ms_per_round, name="engine.sample"),
    "host_reads_per_round": partial(count_per_round, name="host_reads",
                                    span="engine.call"),
    "client_step_ms_per_round": partial(span_ms_per_round,
                                        name="client.step"),
    "client_step_idle": partial(idle_share_under, name="client.step"),
    "client_step_launches_per_round": partial(launches_per_round_under,
                                              name="client.step"),
    "rs_chunk_host_ms": partial(span_ms_per_call, name="rs.chunk"),
    "rowstable_mm_idle": partial(idle_share_under, name="rowstable_mm"),
}
