"""The port's span and counter recorder (`repro_torch.utils.spans`), and
its spans in the engine, the client step and the Secret Sharer: what is
kept, nesting across threads, the profiler's clock, one span per call of a
layer function, and no bit of any output changed by recording."""
import threading

import numpy as np
import pytest
import torch

import torch_sharded_ranks as tr
from repro_torch.core import secret_sharer as ss
from repro_torch.kernels.recompute import RecomputeGrad
from repro_torch.utils import spans
from repro_torch.utils.numerics import ROW_TILE, rowstable_mm
from repro_torch.utils.pytree import tree_leaves


@pytest.fixture
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def test_outside_recording_nothing_is_kept():
    first = spans.span("engine.round", round=0)
    assert first is spans.span("client.step") is spans._NOOP
    with first:
        spans.count("host_reads")
    with spans.recording() as rec:
        pass
    assert rec.spans == [] and dict(rec.counts) == {}
    assert spans._rec is None


def test_nesting_parents_attrs_and_a_raising_body():
    with spans.recording() as rec:
        with spans.span("engine.round", round=4):
            with spans.span("engine.compute"):
                with pytest.raises(ValueError):
                    with spans.span("client.step", clients=2):
                        raise ValueError("planted")
                with spans.span("clip.accumulate"):
                    pass
    by = {s.name: s for s in rec.spans}
    assert set(by) == {"engine.round", "engine.compute", "client.step",
                       "clip.accumulate"}
    assert by["engine.round"].parent is None
    assert by["engine.compute"].parent == by["engine.round"].id
    # the span whose body raised closed, and its sibling has its parent
    assert by["client.step"].parent == by["engine.compute"].id
    assert by["clip.accumulate"].parent == by["engine.compute"].id
    assert by["client.step"].attrs == {"round": 4, "clients": 2}
    assert by["clip.accumulate"].attrs == {"round": 4}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
    outer, inner = by["engine.round"], by["client.step"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_count_sums():
    with spans.recording() as rec:
        for n in (1, 2, 3):
            spans.count("gather_bytes", n)
        spans.count("host_reads")
        spans.count("host_reads")
    assert rec.counts == {"gather_bytes": 6, "host_reads": 2}


def test_a_span_on_another_thread_takes_the_callers_open_span():
    def work():
        with spans.span("recompute.backward"):
            with spans.span("rowstable_mm", blocks=1):
                pass

    with spans.recording() as rec:
        with spans.span("client.step"):
            with spans.span("client.grad", round=3):
                t = threading.Thread(target=work)
                t.start()
                t.join(timeout=30)
    assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    grad, back = by["client.grad"], by["recompute.backward"]
    assert back.parent == grad.id and back.thread != grad.thread
    assert back.attrs == {"round": 3}
    assert by["rowstable_mm"].parent == back.id
    assert by["rowstable_mm"].thread == back.thread


def test_threads_lose_no_span_or_count():
    """More threads than cores, switching every microsecond: every span
    and every count of every thread is kept, and a span's parent on its
    own thread is that thread's open span."""
    import os
    import sys

    n_threads, n_iter = 2 * (os.cpu_count() or 1), 300

    def work(k):
        for i in range(n_iter):
            with spans.span("engine.chunk", thread=k):
                with spans.span("client.step", i=i):
                    spans.count("chunks_live")
                    spans.count("gather_bytes", 3)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with spans.recording() as rec:
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * n_iter
    assert rec.counts == {"chunks_live": total, "gather_bytes": 3 * total}
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) == 2 * total
    steps = rec.by_name("client.step")
    assert len(steps) == total
    for s in steps:
        outer = by_id[s.parent]
        assert outer.name == "engine.chunk" and outer.thread == s.thread
        assert s.attrs["thread"] == outer.attrs["thread"]


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    a, b = torch.randn(256, 256), torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.recording() as rec:
            with spans.span("client.grad"):
                torch.mm(a, b)
    s = rec.by_name("client.grad")[0]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(ops) == 1
    e = ops[0]
    slack = 50_000
    assert s.start_ns - slack <= e.start_ns()
    assert e.start_ns() + e.duration_ns() <= s.end_ns + slack


def test_recompute_backward_and_rowstable_mm_spans_change_no_bit():
    x = torch.linspace(-2.0, 2.0, 7)

    def grad():
        leaf = x.clone().requires_grad_(True)
        y = RecomputeGrad.apply(torch.sin, torch.sin, leaf)
        with spans.span("client.grad"):
            return torch.autograd.grad(y.sum(), leaf)[0]

    a, b = torch.randn(ROW_TILE + 44, 8), torch.randn(8, 5)
    plain = (grad(), rowstable_mm(a, b))
    with spans.recording() as rec:
        recorded = (grad(), rowstable_mm(a, b))
    for p, r in zip(plain, recorded):
        assert torch.equal(p, r)
    by = {s.name: s for s in rec.spans}
    assert by["recompute.backward"].parent == by["client.grad"].id
    assert by["rowstable_mm"].attrs == {"blocks": 2}


@pytest.mark.parametrize("backend", ["device", "streamed"])
def test_engine_spans_one_per_call_round_and_chunk(backend, one_thread):
    """Calls of 2, 2 and 1 rounds (``rounds_per_call`` 2): one history read
    a call, and under the streamed backend the cohort's ids a round."""
    model, ds, params = tr.setup()
    spec = tr.run_spec("fixed", sigma=0.5, backend=backend)
    e = tr.engine(model, ds, spec)
    state = e.init_state(params, seed=0)
    calls = (2, 2, 1)
    with spans.recording() as rec:
        for n in calls:
            state, _ = e.run(state, n)
    rounds = sum(calls)
    live = sum(sum(block) for block in e._fixed_live) * rounds
    got = {}
    for s in rec.spans:
        got[s.name] = got.get(s.name, 0) + 1
    want = {"engine.call": len(calls), "engine.round": rounds,
            "engine.sample": rounds, "engine.compute": rounds,
            "server.step": rounds, "engine.fold": rounds,
            "engine.read": len(calls), "engine.chunk": live,
            "client.gather": live, "client.step": live,
            "clip.accumulate": live,
            "client.grad": live * tr.ENGINE["n_local_batches"],
            "client.update": live * tr.ENGINE["n_local_batches"]}
    if backend == "streamed":
        want["engine.stage"] = rounds
    for name, n in want.items():
        assert got.get(name) == n, name
    reads = len(calls) + (rounds if backend == "streamed" else 0)
    assert rec.counts["host_reads"] == reads
    assert rec.counts["chunks_live"] == live
    assert sorted({s.attrs["round"] for s in rec.by_name("client.step")}) \
        == list(range(rounds))
    for s in rec.by_name("engine.chunk"):
        assert s.attrs["clients"] == e.cohort_chunk


def test_engine_recording_changes_no_bit(one_thread):
    model, ds, params = tr.setup()
    spec = tr.run_spec("fixed", sigma=0.5)
    out = []
    for record in (False, True):
        e = tr.engine(model, ds, spec)
        state = e.init_state(params, seed=0)
        if record:
            with spans.recording():
                state, hist = e.run(state, 3)
        else:
            state, hist = e.run(state, 3)
        out.append((state, hist))
    (s0, h0), (s1, h1) = out
    for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(s0.opt_state.momentum),
                    tree_leaves(s1.opt_state.momentum)):
        assert torch.equal(a, b)
    assert set(h0) == set(h1)
    for k in h0:
        assert np.array_equal(h0[k], h1[k]), k


def test_random_sampling_ranks_spans_and_ranks(one_thread):
    model, _, params = tr.setup()
    canaries = ss.make_canaries(torch.Generator().manual_seed(5),
                                model.cfg.vocab, grid=((1, 1),),
                                per_config=3)
    n, batch = 700, 256

    def ranks():
        return ss.random_sampling_ranks(
            model, params, canaries, torch.Generator().manual_seed(9),
            n_samples=n, batch_size=batch)

    plain = ranks()
    with spans.recording() as rec:
        recorded = ranks()
    assert np.array_equal(plain, recorded)
    chunks = rec.by_name("rs.chunk")
    assert len(chunks) == -(-n // batch)
    assert [s.attrs["chunk"] for s in chunks] == list(range(len(chunks)))
    (p,) = rec.by_name("rs.pass")
    for name in ("rs.canaries", "rs.chunk", "rs.read"):
        assert all(s.parent == p.id for s in rec.by_name(name))
    assert rec.counts["host_reads"] == 1
