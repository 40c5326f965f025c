#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (built for an H100, ``sm_90a``) and ``nvcc``; run from the
root of a checkout. Imports nothing of JAX or of the JAX package. Phases, one
line each (any failure exits non-zero and prints no result):

1. card  — name and power limit, as ``nvidia-smi`` reports them;
2. build — compiles every kernel from the checkout's sources;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card (``cifg_cell_fwd``, ``cifg_cell_bwd``, ``dp_sumsq``,
   ``dp_clip_accumulate``, ``flash_attention_fwd``, ``ssd_scan``), at the
   shapes its path gives it and around them, then timed against its bound,
   the plain version and one PyTorch call where there is one;
4. serve — the paper's CIFG-LSTM at its published widths (vocab 10000,
   d 96, H 256, bf16) through ``ServeEngine``: ~512 sessions, a hot-swap,
   launch counts of every kernel on prefill and decode, token-for-token
   agreement with ``reference_generate`` on sampled sessions;
5. train — DP-FedAvg of the same model through ``FederatedTrainer``
   (host backend): 1000 users, cohort 128, 3 rounds; launch counts, the
   fused path against the plain one on one round, the round sum bitwise
   across cohort chunks, the noise's std, rounds/s and where a round's
   time goes; then the training CLI on a tiny run;
6. grad through decode — the gradient of a loss through 4 ``decode_step``
   calls, through the backward cell kernel, against plain autograd;
7. hybrid serve — ``zamba2-2.7b`` at its published widths (54 Mamba-2
   layers, 9 shared-attention sites, bf16) with random weights from a seed
   through ``generate``: 4 prompts of 512 tokens, 16 decode steps, half
   greedy and half sampled; one ``ssd_scan`` launch per mixer and one
   ``flash_attention_fwd`` launch per site in the prefill; prefill plus
   decode against ``forward`` at full depth; the card's kernels against the
   CPU's plain versions at full width and 6 layers; timings.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12,      # dense tensor-core rate
                  "float32": 67e12}        # outside the tensor cores

# tolerances of kernel vs plain over 16 chained steps: float32 differs only
# in the order of the sum; bfloat16 can flip the rounding of h by one ulp
# (~4e-3 relative) at the next step, which then propagates
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 0.0)}  # (atol, rtol)
# the backward cell: float32 differs in the order of sums of up to 768
# terms; in bfloat16 a one-ulp difference in z can flip the rounding of a
# dz entry before the products
TOL_BWD = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 0.0)}
# the training path at full width, fused (CUDA kernels, time-fused
# backward over f32 w_h) against plain (autograd through the plain cell,
# bf16-rounded cotangents), 3 SGD steps per client: relative L2 of the
# round sum, relative norm, absolute loss and clipped fraction
TOL_ROUND = {"sum": 5e-2, "norm": 1e-2, "loss": 1e-2, "frac": 2 / 128}
# gradient through 4 decode steps, fused against plain autograd: max abs
# error relative to the largest plain gradient entry, per leaf
TOL_DECODE_GRAD = 2e-2
# flash attention against its plain version (atol = rtol): float32 differs
# in the order of the sums; in bfloat16 both round a float32 result once
TOL_FLASH = {"float32": 1e-5, "bfloat16": 2e-2}
# SSD scan: max abs error relative to the largest plain output (float32
# sums in another order)
TOL_SSD = 1e-4
# zamba2-2.7b at full depth, prefill of 256 tokens plus 3 decode steps
# against forward, max abs error relative to the largest logit. float32:
# the chunked scan and the recurrence differ in the order of sums. bfloat16:
# they round at different places, and that compounds over 54 layers (3% of
# the largest logit at this depth in a CPU run at narrow width)
TOL_HYBRID_CONSISTENT = {"float32": 1e-4, "bfloat16": 1e-1}
# the card (kernels) against the CPU (plain versions), full width, 6
# layers, float32: relative to the largest logit
TOL_HYBRID_CPU = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def _events_ms(run, count: int) -> float:
    """CUDA-event time of ``run()`` divided by ``count``."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / count


def cuda_time_ms(fn, iters: int, warmup: int = 10) -> float:
    """Time of one eager ``fn()`` call: CUDA events around ``iters``
    back-to-back calls. Where the host launches more slowly than the card
    runs, this is the host's time per call."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run, iters)


def graph_time_ms(fn, per_graph: int = 50, replays: int = 20) -> float:
    """Device time of one ``fn()`` call: ``per_graph`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so no host
    launch cost falls inside the window. Warm L2, as in a serving tick."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as required
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _events_ms(run, per_graph * replays)
    del graph
    return ms


# ---------------------------------------------------------------- phases


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    say(f"card: {line}")
    return line


def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    info = build.build()
    for name, rec in info.items():
        usage = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "bytes stack" in ln]
        say(f"build: {name} in {rec['seconds']:.1f} s; ptxas: "
            f"{' | '.join(usage) if usage else 'n/a'}")
    say(f"build: all kernels in {time.perf_counter() - t0:.1f} s")
    return info


def _cell_inputs(B, H, gen, dev):
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return (randn(16, B, 3 * H), randn(B, H, scale=0.3),
            randn(B, H, scale=0.3), randn(H, 3 * H, scale=H ** -0.5))


def phase_kernel(dev) -> dict:
    """cifg_cell_fwd vs cifg_cell_ref on the card: bf16 and f32, ragged
    (B 3, H 200) and full shapes, 16 chained steps; the row-position check;
    timings."""
    import torch

    from repro_torch.kernels.cifg_cell import cell_fwd, cifg_cell_ref
    from repro_torch.utils.numerics import round_to

    gen = torch.Generator().manual_seed(1234)
    worst = 0.0
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL[name]
        for B in (1, 3, 256):
            for H in (64, 200, 256):
                zxs, h0, c0, w = _cell_inputs(B, H, gen, dev)
                w = w.to(cd)
                hk, ck, hr, cr = h0, c0, h0, c0
                err_h = err_c = 0.0
                for t in range(16):
                    hk, ck = cell_fwd(zxs[t], hk, ck, w)
                    hr, cr = cifg_cell_ref(zxs[t], hr, cr, w)
                    torch.cuda.synchronize()
                    for a, b in ((hk, hr), (ck, cr)):
                        if not bool(torch.isfinite(a).all()):
                            fail(f"kernel output not finite ({name} B={B} "
                                 f"H={H} step {t})")
                        if not bool(((a - b).abs()
                                     <= atol + rtol * b.abs()).all()):
                            fail(f"kernel disagrees with plain ({name} B={B} "
                                 f"H={H} step {t}): max abs err "
                                 f"{float((a - b).abs().max()):.3e}")
                    err_h = max(err_h, float((hk - hr).abs().max()))
                    err_c = max(err_c, float((ck - cr).abs().max()))
                worst = max(worst, err_h, err_c)
                say(f"kernel: cifg_cell_fwd {name} B={B} H={H} 16 steps: "
                    f"max abs err h {err_h:.3e} c {err_c:.3e} "
                    f"(tol atol {atol:g} rtol {rtol:g})")

    # the engine (B = slots) must match the reference (B = 1) bit for bit
    zxs, h0, c0, w = _cell_inputs(256, 256, gen, dev)
    w = w.to(torch.bfloat16)
    hb, cb = cell_fwd(zxs[0], h0, c0, w)
    for r in (0, 17, 255):
        h1, c1 = cell_fwd(zxs[0, r:r + 1].contiguous(),
                          h0[r:r + 1].contiguous(), c0[r:r + 1].contiguous(),
                          w)
        if not (torch.equal(h1[0], hb[r]) and torch.equal(c1[0], cb[r])):
            fail(f"kernel row {r} differs between B=256 and B=1")
    say("kernel: rows of B=256 are bitwise those of B=1")

    # timings at the decode shape of the serving path: device time (CUDA
    # graph) for the kernel, its plain version and the PyTorch yardstick;
    # then the time of one eager call through the wrapper
    B, H, cd = 256, 256, torch.bfloat16
    zx, h, c = zxs[0], h0, c0
    w32 = round_to(w, cd)

    def library():
        z = torch.addmm(zx, round_to(h, cd), w32)
        f = torch.sigmoid(z[:, :H] + 1.0)
        o = torch.sigmoid(z[:, H:2 * H])
        g = torch.tanh(z[:, 2 * H:])
        cn = f * c + (1.0 - f) * g
        return o * torch.tanh(cn), cn

    zx1, h1, c1 = (t[:1].contiguous() for t in (zx, h, c))
    ms = graph_time_ms(lambda: cell_fwd(zx, h, c, w))
    plain_ms = graph_time_ms(lambda: cifg_cell_ref(zx, h, c, w))
    library_ms = graph_time_ms(library)
    ms_b1 = graph_time_ms(lambda: cell_fwd(zx1, h1, c1, w))
    eager_ms = cuda_time_ms(lambda: cell_fwd(zx, h, c, w), 2000)
    eager_b1 = cuda_time_ms(lambda: cell_fwd(zx1, h1, c1, w), 2000)
    nbytes = (zx.numel() + h.numel() + c.numel() + 2 * B * H) * 4 \
        + w.numel() * w.element_size()
    ops = 2 * B * H * 3 * H
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S["bfloat16"] * 1e3
    bound_ms = max(t_bytes, t_ops)
    say(f"kernel: cifg_cell_fwd bf16 B={B} H={H}, device time: "
        f"{ms * 1e3:.2f} us/launch; plain {plain_ms * 1e3:.2f} us; "
        f"addmm+gates {library_ms * 1e3:.2f} us; bound "
        f"{bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} "
        f"GFLOP); B=1 (a prefill step) {ms_b1 * 1e3:.2f} us")
    say(f"kernel: cifg_cell_fwd one eager call through the wrapper: B={B} "
        f"{eager_ms * 1e3:.2f} us, B=1 {eager_b1 * 1e3:.2f} us")
    return {"name": "cifg_cell_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/cifg_cell/csrc/cifg_cell_fwd.cu",
            "replaces": "src/repro/kernels/cifg_cell/cifg_cell.py:77",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _counting(fn, counts: dict, key: str, launches: dict):
    """Wrap a model entry point: add the kernel launches made inside each
    call to ``counts[key]``."""
    def wrapped(*args, **kw):
        before = launches["cifg_cell_fwd"]
        out = fn(*args, **kw)
        counts[key] += launches["cifg_cell_fwd"] - before
        return out
    return wrapped


def tick_breakdown(model, params, dev, slots: int) -> dict:
    """The two device halves of a decode tick at ``slots`` rows, each timed
    on the device (CUDA graph) and as one eager call: ``decode_step`` (input
    projection, cell kernel, logits) and the pick (sampling and top-k)."""
    import torch

    from repro_torch.serve import sampling

    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    cache = model.init_cache(slots, 64, device=dev)
    cache["h"].copy_(torch.randn((slots, cfg.d_ff), generator=gen) * 0.3)
    cache["c"].copy_(torch.randn((slots, cfg.d_ff), generator=gen) * 0.3)
    toks = torch.randint(4, cfg.vocab, (slots,), generator=gen).to(dev)
    keys = torch.randint(0, 2 ** 32, (slots, 2), generator=gen).to(dev)
    ts = torch.full((slots,), 3, dtype=torch.int64, device=dev)
    temps = torch.tensor([0.0, 0.8] * (slots // 2), device=dev)
    logits, _ = model.decode_step(params, toks, cache)
    lg = logits[:, :cfg.vocab]

    def decode():
        model.decode_step(params, toks, cache)

    def pick():
        sampling.sample_tokens(lg, keys, ts, temps)
        sampling.topk_ids(lg, 3)

    return {"decode_dev": graph_time_ms(decode, per_graph=10),
            "pick_dev": graph_time_ms(pick, per_graph=10),
            "decode_eager": cuda_time_ms(decode, 50),
            "pick_eager": cuda_time_ms(pick, 50)}


def phase_serve(dev, kernel: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.models import build
    from repro_torch.serve import NwpRequest, ServeEngine, reference_generate

    cfg = get_config("gboard-cifg-lstm")
    if (cfg.vocab, cfg.d_model, cfg.d_ff, cfg.compute_dtype) != (
            10_000, 96, 256, "bfloat16"):
        fail(f"unexpected gboard-cifg-lstm widths: {cfg}")
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=dev)
    params_b = model.init(torch.Generator().manual_seed(1), device=dev)

    # outputs: finite, the expected shape, and the fused path agrees with
    # the plain cell on the same card (bf16: tolerance, not bits)
    toks = torch.randint(4, cfg.vocab, (4, 16),
                         generator=torch.Generator().manual_seed(2))
    lf = model.forward(params, {"tokens": toks})
    ls = build(cfg.with_(cell_path="seq")).forward(params, {"tokens": toks})
    if tuple(lf.shape) != (4, 16, 10240) or not bool(torch.isfinite(lf).all()):
        fail(f"forward logits bad: shape {tuple(lf.shape)}")
    fwd_err = float((lf - ls).abs().max())
    if fwd_err > 3e-2:
        fail(f"fused forward disagrees with the plain cell: {fwd_err:.3e}")

    launches = cell_ops.LAUNCHES
    counts = {"prefill": 0, "decode": 0}
    counted = model._replace(
        prefill=_counting(model.prefill, counts, "prefill", launches),
        decode_step=_counting(model.decode_step, counts, "decode", launches))

    rng = np.random.default_rng(0)
    n_sessions, steps = 512, 8
    reqs = []
    for i in range(n_sessions):
        L = int(rng.integers(2, 17))
        hot = i % 2 == 1
        reqs.append(NwpRequest(
            prompt=tuple(int(t) for t in rng.integers(4, cfg.vocab, L)),
            steps=steps, temperature=0.8 if hot else 0.0,
            seed=1000 + i if hot else None))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches["cifg_cell_fwd"] = 0
    t_run = time.perf_counter()
    engine = ServeEngine(counted, params, max_slots=256, top_k=3)
    sids = [engine.submit(r) for r in reqs]
    tick_ms = []
    swap_tick = None
    while True:
        if engine.ticks == 4 and swap_tick is None:
            engine.swap_params(params_b)
            swap_tick = engine.ticks
        n_adm = len(engine.admission_times_s)
        t0 = time.perf_counter()
        more = engine.step()
        dt = time.perf_counter() - t0
        if len(engine.admission_times_s) == n_adm and engine.active_sessions:
            tick_ms.append(dt * 1e3)
        if not more:
            break
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    total_launches = launches["cifg_cell_fwd"]
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20

    if counts["prefill"] <= 0 or counts["decode"] <= 0:
        fail(f"cell kernel not launched on both paths: {counts}")
    if not engine.bucketed_admission:
        fail("bucketed admission is off: the length probe failed")
    results = [engine.result(s) for s in sids]
    if any(r.status != "done" or len(r.tokens) != steps for r in results):
        fail("not every session finished done with all its tokens")
    straddled = 0
    for r in results:
        vs = list(r.params_versions)
        if vs != sorted(vs) or not set(vs) <= {0, 1}:
            fail(f"{r.session_id}: params versions {vs}")
        if r.admit_tick > swap_tick and set(vs) != {1}:
            fail(f"{r.session_id} admitted after the swap saw {vs}")
        straddled += vs[0] == 0 and vs[-1] == 1
    if straddled == 0:
        fail("no session crossed the hot-swap")

    picks = sorted(rng.choice(n_sessions, 16, replace=False).tolist())
    for i in picks:
        r, req = results[i], reqs[i]
        vs = list(r.params_versions)
        swaps = [] if 1 not in vs else [(vs.index(1), params_b)]
        toks_ref, cands_ref = reference_generate(
            model, params, req.prompt, req.steps,
            temperature=req.temperature, seed=req.seed, top_k=3, swaps=swaps)
        if r.tokens != toks_ref or not np.array_equal(r.candidates,
                                                      cands_ref):
            fail(f"session {i} differs from reference_generate: "
                 f"{r.tokens} vs {toks_ref}")

    adm = np.asarray(engine.admission_times_s) * 1e3
    n_tokens = sum(len(r.tokens) for r in results)
    tick = float(np.mean(tick_ms))
    say(f"serve: {n_sessions} sessions x {steps} tokens, 256 slots, bf16, "
        f"cell_path auto->fused: {engine.decode_ticks} decode ticks, "
        f"{n_tokens} tokens in {run_s:.2f} s ({n_tokens / run_s:.0f} "
        f"tokens/s incl. admission); decode tick {tick:.3f} ms "
        f"({1e3 / tick:.1f} ticks/s, {256 * 1e3 / tick:.0f} tokens/s at "
        f"256 slots); admission p50 {np.percentile(adm, 50):.2f} ms p99 "
        f"{np.percentile(adm, 99):.2f} ms; peak device memory "
        f"{peak_mb:.1f} MiB; cell kernel {kernel['ms'] * 1e3:.2f} us = "
        f"{100 * kernel['ms'] / tick:.2f}% of a decode tick; launches "
        f"prefill {counts['prefill']} decode {counts['decode']} (1 per "
        f"tick); swap at tick {swap_tick}, {straddled} sessions crossed "
        f"it; 16/16 sampled sessions match reference_generate; fused vs "
        f"plain forward max abs err {fwd_err:.2e}")

    bd = tick_breakdown(model, params, dev, 256)
    busy = bd["decode_dev"] + bd["pick_dev"]
    say(f"tick at 256 slots: decode_step {bd['decode_dev']:.3f} ms on the "
        f"device, {bd['decode_eager']:.3f} ms as an eager call; sampling + "
        f"top-k {bd['pick_dev']:.3f} ms on the device, "
        f"{bd['pick_eager']:.3f} ms eager; rest of the {tick:.3f} ms tick "
        f"(host bookkeeping, copies) "
        f"{tick - bd['decode_eager'] - bd['pick_eager']:.3f} ms; device busy "
        f"{100 * busy / tick:.1f}% of the tick")
    return {"launches": total_launches}


def _bound(nbytes: float, ops: float, dtype: str):
    """(bound_ms, bound_by) of work moving ``nbytes`` and doing ``ops``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bwd_inputs(B, H, gen, dev, cd):
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return (randn(B, 3 * H), randn(H, 3 * H, scale=H ** -0.5).to(cd),
            randn(B, H, scale=0.3), randn(B, H, scale=0.3),
            randn(B, H, scale=0.1), randn(B, H, scale=0.1))


def phase_kernel_bwd(dev, B_main: int = 10) -> dict:
    """cifg_cell_bwd vs cell_bwd_ref on the card: bf16 and f32, B 1, 10,
    256 × H 64, 200, 256, all four outputs; repeatability; timings at the
    decode-gradient shape (B_main, H 256, bf16) and at B=256."""
    import torch

    from repro_torch.kernels.cifg_cell import cell_bwd, cell_bwd_ref
    from repro_torch.utils.numerics import round_to

    gen = torch.Generator().manual_seed(4321)
    worst = 0.0
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL_BWD[name]
        for B in (1, 10, 256):
            for H in (64, 200, 256):
                args = _bwd_inputs(B, H, gen, dev, cd)
                got = cell_bwd(*args)
                want = cell_bwd_ref(*args)
                torch.cuda.synchronize()
                errs = []
                for what, a, b in zip(("dzx", "dh", "dc", "dw_h"), got, want):
                    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                        fail(f"cifg_cell_bwd {what} bad ({name} B={B} H={H})")
                    if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                        fail(f"cifg_cell_bwd {what} disagrees with plain "
                             f"({name} B={B} H={H}): max abs err "
                             f"{float((a - b).abs().max()):.3e}")
                    errs.append(float((a - b).abs().max()))
                again = cell_bwd(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"cifg_cell_bwd not repeatable ({name} B={B} H={H})")
                worst = max(worst, *errs)
                say(f"kernel: cifg_cell_bwd {name} B={B} H={H}: max abs err "
                    f"dzx {errs[0]:.2e} dh {errs[1]:.2e} dc {errs[2]:.2e} "
                    f"dw_h {errs[3]:.2e} (tol atol {atol:g} rtol {rtol:g}); "
                    f"bitwise repeatable")

    H, cd = 256, torch.bfloat16
    out = {"name": "cifg_cell_bwd", "route": "cuda",
           "source": "src/repro_torch/kernels/cifg_cell/csrc/cifg_cell_bwd.cu",
           "replaces": "src/repro/kernels/cifg_cell/cifg_cell.py:122",
           "max_abs_err": worst}
    for B in (B_main, 256):
        zx, w, h, c, dh, dc = _bwd_inputs(B, H, gen, dev, cd)
        w32, hc = round_to(w, cd), round_to(h, cd)

        def library():
            z = torch.addmm(zx, hc, w32)
            f = torch.sigmoid(z[:, :H] + 1.0)
            o = torch.sigmoid(z[:, H:2 * H])
            g = torch.tanh(z[:, 2 * H:])
            t = torch.tanh(f * c + (1.0 - f) * g)
            dct = dc + dh * o * (1.0 - t * t)
            dz = torch.cat([dct * (c - g) * f * (1.0 - f),
                            dh * t * o * (1.0 - o),
                            dct * (1.0 - f) * (1.0 - g * g)], dim=1)
            dzc = round_to(dz, cd)
            return dz, torch.mm(dzc, w32.t()), dct * f, torch.mm(hc.t(), dzc)

        ms = graph_time_ms(lambda: cell_bwd(zx, w, h, c, dh, dc))
        plain_ms = graph_time_ms(lambda: cell_bwd_ref(zx, w, h, c, dh, dc))
        library_ms = graph_time_ms(library)
        eager_ms = cuda_time_ms(lambda: cell_bwd(zx, w, h, c, dh, dc), 1000)
        nbytes = (B * 3 * H * 4 + H * 3 * H * 2 + 4 * B * H * 4
                  + B * 3 * H * 4 + 2 * B * H * 4 + H * 3 * H * 4)
        ops = 3 * 2 * B * H * 3 * H
        bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
        say(f"kernel: cifg_cell_bwd bf16 B={B} H={H}, device time: "
            f"{ms * 1e3:.2f} us/launch (4 kernels); plain {plain_ms * 1e3:.2f}"
            f" us; cuBLAS products + elementwise {library_ms * 1e3:.2f} us; "
            f"bound {bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, "
            f"{ops / 1e9:.3f} GFLOP); one eager call {eager_ms * 1e3:.2f} us")
        if B == B_main:
            out.update(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
    return out


CLIP_SIZES = (1, 127, 32769, 983040, 196608)


def phase_kernel_clip(dev) -> list:
    """dp_sumsq and dp_clip_accumulate vs their plain versions at ragged
    lengths and at the model's leaf sizes: sumsq within float tolerance and
    bitwise repeatable; the accumulate bitwise equal to plain, and a zero
    factor over 1e30 garbage leaves acc bitwise unchanged. Timed at the
    largest leaf (the 10240 x 96 embedding)."""
    import torch

    from repro_torch.kernels.dp_clip import clip_accumulate_leaf, sumsq
    from repro_torch.kernels.dp_clip.ref import (clip_accumulate_ref,
                                                 sumsq_ref)

    gen = torch.Generator().manual_seed(77)
    worst_ss = 0.0
    for n in CLIP_SIZES:
        x = torch.randn((n,), generator=gen).to(dev)
        acc = torch.randn((n,), generator=gen).to(dev)
        s1, s2 = sumsq(x), sumsq(x)
        ref = sumsq_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2):
            fail(f"dp_sumsq not repeatable at n={n}")
        rel = float((s1 - ref).abs() / ref.abs().clamp(min=1e-30))
        if rel > 1e-5:
            fail(f"dp_sumsq disagrees with plain at n={n}: rel err {rel:.2e}")
        worst_ss = max(worst_ss, float((s1 - ref).abs()))
        factor = torch.clamp(0.8 / torch.sqrt(s1), max=1.0)
        out = clip_accumulate_leaf(acc, x, factor)
        if not torch.equal(out, clip_accumulate_ref(acc, x, factor)):
            fail(f"dp_clip_accumulate differs from plain at n={n}")
        garbage = torch.full((n,), 1e30, device=dev)
        garbage[::2] = -1e30
        zero = torch.zeros((), device=dev)
        if not torch.equal(clip_accumulate_leaf(acc, garbage, zero), acc):
            fail(f"dp_clip_accumulate: factor 0 over 1e30 changed acc, n={n}")
        say(f"kernel: dp_sumsq n={n}: rel err {rel:.2e} (tol 1e-5), bitwise "
            f"repeatable; dp_clip_accumulate bitwise equal to plain, zero "
            f"factor over 1e30 leaves acc unchanged")

    n = 983040
    x = torch.randn((n,), generator=gen).to(dev)
    acc = torch.randn((n,), generator=gen).to(dev)
    factor = torch.tensor(0.37, device=dev)
    rows = []
    for name, fn, plain, lib, nbytes, replaces in (
            ("dp_sumsq", lambda: sumsq(x), lambda: sumsq_ref(x),
             lambda: torch.dot(x, x), 4 * n + 4,
             "src/repro/kernels/dp_clip/dp_clip.py:66"),
            ("dp_clip_accumulate", lambda: clip_accumulate_leaf(acc, x, factor),
             lambda: clip_accumulate_ref(acc, x, factor),
             lambda: torch.add(acc, x, alpha=0.37), 3 * 4 * n + 4,
             "src/repro/kernels/dp_clip/dp_clip.py:87")):
        ms = graph_time_ms(fn)
        plain_ms = graph_time_ms(plain)
        library_ms = graph_time_ms(lib)
        eager_ms = cuda_time_ms(fn, 1000)
        bound_ms, bound_by = _bound(nbytes, 2 * n, "float32")
        say(f"kernel: {name} n={n} f32, device time: {ms * 1e3:.2f} us/launch;"
            f" plain {plain_ms * 1e3:.2f} us; "
            f"{'torch.dot' if name == 'dp_sumsq' else 'torch.add(alpha)'} "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
            f"({nbytes / 1e6:.2f} MB); one eager call {eager_ms * 1e3:.2f} us")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/dp_clip/csrc/dp_clip.cu",
                     "replaces": replaces,
                     "max_abs_err": worst_ss if name == "dp_sumsq" else 0.0,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    return rows


def profiled_device_ms(fn, iters: int, warmup: bool = True, top: int = 6):
    """Device (kernel) time per ``fn()`` call over ``iters`` calls, from
    ``torch.profiler``'s CUDA activity, the host wall time per call of the
    profiled window, and the ``top`` kernels (all for ``None``) with the
    most device time as (name, ms per call, launches per call); device time
    is None when the profiler saw no kernel. Only the kernel events are
    summed: an operator's own device time is its kernels' time counted a
    second time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    dev_us = sum(e.self_device_time_total for e in avgs)
    top = sorted(avgs, key=lambda e: -e.self_device_time_total)[:top]
    top = [(e.key[:48], e.self_device_time_total / 1e3 / iters,
            e.count / iters) for e in top]
    return (dev_us / 1e3 / iters if dev_us > 0 else None,
            wall * 1e3 / iters, top)


def _fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def phase_train(dev, n_users: int = 1000, cohort: int = 128,
                vocab: int = 10_000) -> dict:
    """DP-FedAvg of gboard-cifg-lstm at full width through
    FederatedTrainer(backend="host"): 3 rounds with the launch counters
    read around them; fused against plain on one round; the round sum
    bitwise across cohort_chunk; the noise std; timings; the CLI."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.core.clipping import clip_accumulate_tree
    from repro_torch.core.dp_fedavg import finalize_round
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fl.client import local_sgd, round_compute
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.round import FederatedTrainer
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build
    from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_size,
                                          tree_zeros_like)

    cfg = get_config("gboard-cifg-lstm")
    if vocab != cfg.vocab:
        cfg = cfg.with_(vocab=vocab)
    model = build(cfg)
    seq_len, batch, n_batches, rounds = 16, 10, 3, 3
    t0 = time.perf_counter()
    corpus = BigramCorpus(vocab_size=cfg.vocab, seed=0)
    ds = FederatedDataset(corpus, n_users=n_users, seq_len=seq_len,
                          sentences_per_user=30)
    data_s = time.perf_counter() - t0
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                  server_momentum=0.9)
    cl = ClientConfig(local_epochs=1, batch_size=batch, lr=0.3)
    pop = PopulationSim(n_users, availability=0.3, seed=0)
    trainer = FederatedTrainer(model, ds, dp, cl, pop=pop, seed=0,
                               n_local_batches=n_batches, device=dev)
    n_params = tree_size(trainer.state.params)

    counters = (cell_ops.LAUNCHES, clip_ops.LAUNCHES)
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    recs = [trainer.run_round() for _ in range(rounds)]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {**cell_ops.LAUNCHES, **clip_ops.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    clients = sum(r["n_clients"] for r in recs)
    if any(r["n_clients"] != cohort for r in recs) or cohort % 8:
        fail(f"rounds of {[r['n_clients'] for r in recs]} clients: the "
             f"launch counts below assume full rounds of a multiple of 8")
    if not all(np.isfinite(r["loss"]) for r in recs):
        fail(f"training losses not finite: {[r['loss'] for r in recs]}")
    want = {"cifg_cell_fwd": seq_len * n_batches * clients,
            "dp_sumsq": 5 * clients, "dp_clip_accumulate": 5 * clients}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"training launched {k} {launches[k]} times, expected {v} "
                 f"({clients} clients over {rounds} rounds)")
    say(f"train: gboard-cifg-lstm vocab {cfg.vocab} (padded "
        f"{-(-cfg.vocab // 256) * 256}) d {cfg.d_model} H {cfg.d_ff} "
        f"{cfg.compute_dtype}, {n_params} parameters; {n_users} users "
        f"(made in {data_s:.1f} s), cohort {cohort}, {n_batches} batches of "
        f"{batch} x {seq_len} per client: {rounds} rounds in {run_s:.2f} s = "
        f"{rounds / run_s:.3f} rounds/s; losses "
        f"{[round(r['loss'], 4) for r in recs]}; norms "
        f"{[round(r['mean_update_norm'], 4) for r in recs]}; clipped "
        f"{[r['frac_clipped'] for r in recs]}; launches {launches}; peak "
        f"device memory {peak_mb:.1f} MiB, {peak_mb - base_mb:.1f} MiB above "
        f"what was allocated before the rounds")

    # one round's body on fixed batches: fused vs plain, and chunk sizes
    rng = np.random.default_rng(5)
    ids = rng.choice(n_users, cohort, replace=False)
    tensors = [ds.user_tensor(int(u), batch, n_batches, rng) for u in ids]
    stacked = {k: torch.from_numpy(np.stack([t[k] for t in tensors])).to(dev)
               for k in tensors[0]}
    params = trainer.state.params
    fused = round_compute(model, params, stacked, cl, dp)
    plain = round_compute(build(cfg.with_(cell_path="ref")), params, stacked,
                          cl, dp, clip_path="tree")
    num = sum(float(((a - b) ** 2).sum()) for a, b in
              zip(tree_leaves(fused[0]), tree_leaves(plain[0])))
    den = sum(float((b ** 2).sum()) for b in tree_leaves(plain[0]))
    errs = {"sum": (num / max(den, 1e-30)) ** 0.5,
            "norm": abs(float(fused[1]) / float(plain[1]) - 1.0),
            "loss": abs(float(fused[3]) - float(plain[3])),
            "frac": abs(float(fused[2]) - float(plain[2]))}
    for k, e in errs.items():
        if not e <= TOL_ROUND[k]:
            fail(f"fused round disagrees with plain: {k} err {e:.3e} > "
                 f"{TOL_ROUND[k]:g} ({errs})")
    say(f"train: one round, fused (CUDA cell + dp_clip kernels) vs plain "
        f"(cell_path ref, clip_path tree): rel L2 of the sum "
        f"{errs['sum']:.2e}, norm {float(fused[1]):.5f} vs "
        f"{float(plain[1]):.5f}, frac {float(fused[2]):.4f} vs "
        f"{float(plain[2]):.4f}, loss {float(fused[3]):.5f} vs "
        f"{float(plain[3]):.5f} (tol {TOL_ROUND})")

    blk = cohort // 8
    chunks = [c for c in (1, 2, 4, 8, 16) if blk % c == 0]
    t0 = time.perf_counter()
    base = round_compute(model, params, stacked, cl, dp, cohort_chunk=blk)
    for c in chunks:
        if c == blk:
            continue
        other = round_compute(model, params, stacked, cl, dp, cohort_chunk=c)
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(base[0]), tree_leaves(other[0])))
        same &= all(torch.equal(a, b) for a, b in zip(base[1:], other[1:]))
        if not same:
            fail(f"round sum differs between cohort_chunk {blk} and {c}")
    say(f"train: round sum and stats bitwise equal across cohort_chunk "
        f"{chunks} (block size {blk}) in {time.perf_counter() - t0:.1f} s")

    sigma = dp.noise_multiplier * dp.clip_norm / cohort
    noised, _ = finalize_round(tree_zeros_like(params), cohort,
                               trainer.generator, dp)
    flat = torch.cat([l.reshape(-1) for l in tree_leaves(noised)])
    std = float(flat.std())
    if abs(std / sigma - 1.0) > 0.02:
        fail(f"noise std {std:.4e} vs zS/qN {sigma:.4e}")
    say(f"train: noise std over {flat.numel()} entries {std:.5e} vs zS/qN "
        f"{sigma:.5e} ({100 * (std / sigma - 1):+.2f}%, tol 2%)")

    # where a client's time goes: one local SGD step, one clip + accumulate
    one = {k: v[0] for k, v in stacked.items()}
    step_batches = {k: v[:1] for k, v in one.items()}
    step = lambda: local_sgd(model, params, step_batches, cl)  # noqa: E731
    delta = tree_map(lambda l: torch.randn_like(l) * 1e-3, params)
    acc = tree_zeros_like(params)
    mi = torch.ones((), device=dev)
    clip = lambda: clip_accumulate_tree(acc, delta, dp.clip_norm,  # noqa: E731
                                        scale=mi)
    step_eager = cuda_time_ms(step, 20, warmup=3)
    step_dev, _, step_top = profiled_device_ms(step, 5)
    clip_eager = cuda_time_ms(clip, 200)
    clip_dev, _, _ = profiled_device_ms(clip, 20)
    round_dev, round_wall, _ = profiled_device_ms(trainer.run_round, 1,
                                                  warmup=False)
    busy = None if round_dev is None else 100 * round_dev / round_wall
    round_ms = run_s / rounds * 1e3
    say(f"train: one client SGD step (batch {batch} x {seq_len}) "
        f"{step_eager:.3f} ms eager, {_fmt_ms(step_dev)} on the device; "
        f"clip + accumulate of one client {clip_eager:.3f} ms eager, "
        f"{_fmt_ms(clip_dev)} on the device; a round {round_ms:.1f} ms "
        f"= {cohort * n_batches} client steps x {step_eager:.3f} ms + "
        f"{cohort} clips x {clip_eager:.3f} ms + "
        f"{round_ms - cohort * (n_batches * step_eager + clip_eager):.1f} ms "
        f"else; device busy "
        f"{'not measured' if busy is None else f'{busy:.1f}%'} of a profiled "
        f"round ({_fmt_ms(round_dev)} of {round_wall:.1f} ms under the "
        f"profiler)")
    say("train: device time of one client step by kernel: " + "; ".join(
        f"{name} {ms * 1e3:.1f} us x{n:g}" for name, ms, n in step_top))

    with tempfile.TemporaryDirectory() as tmp:
        ck = train_main(
            ["--vocab", "300", "--rounds", "2", "--n-users", "60",
             "--clients-per-round", "8", "--out", tmp,
             "--device", str(dev)])
        size = Path(ck).stat().st_size
    if size < 1000:
        fail(f"training CLI wrote a {size}-byte checkpoint")
    if "msgpack" in sys.modules:
        fail("the training path imported msgpack")
    say(f"train: CLI tiny run wrote a {size}-byte checkpoint without msgpack")
    return {"launches": launches, "rounds_per_s": rounds / run_s}


def phase_decode_grad(dev, vocab: int = 10_000) -> int:
    """Gradient of a loss through 4 decode_step calls of the full-width
    model: cell_path fused (the forward kernel, the backward kernel as its
    gradient) against ref (plain autograd through the plain cell). Returns
    the backward kernel's launches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.models import build
    from repro_torch.models.layers import lm_loss
    from repro_torch.utils.params import strip_compute
    from repro_torch.utils.pytree import tree_leaves

    cfg = get_config("gboard-cifg-lstm")
    if vocab != cfg.vocab:
        cfg = cfg.with_(vocab=vocab)
    B, steps = 10, 4
    gen = torch.Generator().manual_seed(11)
    params = strip_compute(build(cfg).init(gen, device=dev))
    toks = torch.randint(4, cfg.vocab, (steps + 1, B), generator=gen).to(dev)
    h0 = (torch.randn((B, cfg.d_ff), generator=gen) * 0.3).to(dev)
    c0 = (torch.randn((B, cfg.d_ff), generator=gen) * 0.3).to(dev)

    def grads(path):
        m = build(cfg.with_(cell_path=path))
        leaves = tree_leaves(params)
        for l in leaves:
            l.requires_grad_(True)
        cache = {"h": h0, "c": c0,
                 "pos": torch.zeros((B,), dtype=torch.int32, device=dev)}
        loss = 0.0
        for t in range(steps):
            logits, cache = m.decode_step(params, toks[t], cache)
            loss = loss + lm_loss(logits[:, None, :], toks[t + 1][:, None],
                                  cfg.vocab)
        g = torch.autograd.grad(loss, leaves)
        for l in leaves:
            l.requires_grad_(False)
        return g

    torch.cuda.synchronize()
    cell_ops.LAUNCHES["cifg_cell_bwd"] = 0
    g_fused = grads("fused")
    torch.cuda.synchronize()
    launches = cell_ops.LAUNCHES["cifg_cell_bwd"]
    if launches != steps:
        fail(f"cifg_cell_bwd launched {launches} times through {steps} "
             f"decode steps")
    g_ref = grads("ref")
    worst = 0.0
    for i, (a, b) in enumerate(zip(g_fused, g_ref)):
        if not bool(torch.isfinite(a).all()):
            fail(f"decode gradient of leaf {i} not finite")
        rel = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
        worst = max(worst, rel)
        if rel > TOL_DECODE_GRAD:
            fail(f"decode gradient of leaf {i} disagrees: rel err {rel:.3e}")
    say(f"decode grad: {steps} decode steps at B={B}, full width: fused vs "
        f"plain autograd, worst leaf max abs err / max |grad| {worst:.2e} "
        f"(tol {TOL_DECODE_GRAD:g}); cifg_cell_bwd launches {launches}")
    return launches


def _attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave valid: the work this input needs."""
    import torch

    q = torch.arange(Sq)[:, None]
    k = torch.arange(Sk)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= k <= q
    if window > 0:
        mask &= k > q - window
    return int(mask.sum())


# (B, S, H, KV, hd, causal, window, dtype): the path's shape first
FLASH_CASES = (
    (4, 512, 32, 32, 80, True, 0, "bfloat16"),
    (4, 512, 32, 32, 64, True, 0, "bfloat16"),
    (2, 512, 32, 32, 128, True, 0, "bfloat16"),
    (2, 512, 32, 8, 80, True, 0, "bfloat16"),
    (3, 100, 32, 32, 80, True, 0, "bfloat16"),
    (2, 512, 32, 32, 80, True, 128, "bfloat16"),
    (2, 512, 32, 32, 80, False, 0, "bfloat16"),
    (2, 512, 32, 32, 80, True, 0, "float32"),
    (2, 100, 8, 2, 96, False, 64, "float32"),
)


def phase_kernel_flash(dev) -> dict:
    """flash_attention_fwd vs its plain version at the hybrid prefill's
    shape (B 4, S 512, 32 heads, hd 80, causal, bf16) and around it (hd 64
    and 128, GQA, ragged S, window, bidirectional, f32); timed at the
    path's shape against its bound, the plain version and SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    gen = torch.Generator().manual_seed(5150)
    worst = 0.0
    for B, S, H, KV, hd, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref = flash_attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = TOL_FLASH[dname]
        what = (f"{dname} B={B} S={S} H={H} KV={KV} hd={hd} causal={causal}"
                f" window={window}")
        if out.shape != q.shape or out.dtype != q.dtype or not bool(
                torch.isfinite(out).all()):
            fail(f"flash_attention_fwd output bad ({what})")
        err = float((out.float() - ref.float()).abs().max())
        if not bool(((out.float() - ref.float()).abs()
                     <= tol + tol * ref.float().abs()).all()):
            fail(f"flash_attention_fwd disagrees with plain ({what}): max "
                 f"abs err {err:.3e}")
        worst = max(worst, err)
        say(f"kernel: flash_attention_fwd {what}: max abs err {err:.2e} "
            f"(tol atol = rtol = {tol:g})")

    B, S, H, KV, hd, causal, window, dname = FLASH_CASES[0]
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = graph_time_ms(lambda: flash_attention(q, k, v), per_graph=20)
    plain_ms = graph_time_ms(lambda: flash_attention_ref(q, k, v),
                             per_graph=5)
    library_ms = graph_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), per_graph=20)
    eager_ms = cuda_time_ms(lambda: flash_attention(q, k, v), 100)
    pairs = _attention_pairs(S, S, causal, window)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops = 4 * B * H * hd * pairs
    bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
    say(f"kernel: flash_attention_fwd bf16 B={B} S={S} H={H} hd={hd} causal,"
        f" device time: {ms * 1e3:.2f} us/launch; plain {plain_ms * 1e3:.2f}"
        f" us; F.scaled_dot_product_attention {library_ms * 1e3:.2f} us; "
        f"bound {bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, "
        f"{ops / 1e9:.3f} GFLOP, {bound_by}); one eager call "
        f"{eager_ms * 1e3:.2f} us")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:76",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# (B, S, H, p, N): the path's shape first; mamba2-370m's N 128; a ragged S
SSD_CASES = ((4, 512, 80, 64, 64), (1, 512, 32, 64, 128),
             (2, 200, 80, 64, 64), (2, 128, 80, 64, 64))


def _ssd_inputs(B, S, H, p, N, gen, dev):
    import torch
    import torch.nn.functional as F

    x = torch.randn((B, S, H, p), generator=gen)
    dt = F.softplus(torch.randn((B, S, H), generator=gen)) * 0.1
    Bm = torch.randn((B, S, N), generator=gen)
    Cm = torch.randn((B, S, N), generator=gen)
    A = -torch.exp(torch.randn((H,), generator=gen))
    return [t.to(dev) for t in (x, dt, Bm, Cm, A)]


def _ssd_ops(B: int, S: int, H: int, p: int, N: int) -> int:
    """Operations the chunked scan needs for these shapes from a zero
    state. B and C have no head axis, so the lower triangle of C·Bᵀ is
    needed once per (b, chunk); per (b, h, chunk) its two scalings (by L and
    by dt) and W·x on the lower triangle, C·state for every chunk after the
    first, and the state update."""
    Q, chunks = 128, -(-S // 128)
    tri = Q * (Q + 1) // 2
    per_head = tri * 2 + tri * 2 * p + Q * N * (2 * p + 1)
    return (B * chunks * tri * 2 * N
            + B * H * (chunks * per_head + (chunks - 1) * Q * N * p * 2))


def phase_kernel_ssd(dev) -> dict:
    """ssd_scan vs the plain chunked scan at the hybrid prefill's shape
    (B 4, S 512, H 80, p 64, N 64) and around it (N 128, S 200, S 128), y
    and the final state; timed at the path's shape against its bound and
    the plain version (no single PyTorch call computes the scan)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    gen = torch.Generator().manual_seed(6160)
    worst = 0.0
    for B, S, H, p, N in SSD_CASES:
        x, dt, Bm, Cm, A = _ssd_inputs(B, S, H, p, N, gen, dev)
        y, st = ssd_scan(x, dt, Bm, Cm, A)
        pad = (-S) % 128
        padded = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                  for t in (x, dt, Bm, Cm)]
        yr, sr = ssd_chunked(*padded, A, torch.zeros_like(st))
        yr = yr[:, :S]
        torch.cuda.synchronize()
        errs = []
        for what, a, b in (("y", y, yr), ("state", st, sr)):
            if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                fail(f"ssd_scan {what} bad (B={B} S={S} H={H} p={p} N={N})")
            err = float((a - b).abs().max())
            rel = err / float(b.abs().max())
            if rel > TOL_SSD:
                fail(f"ssd_scan {what} disagrees with plain (B={B} S={S} "
                     f"H={H} p={p} N={N}): rel err {rel:.3e}")
            errs.append(rel)
            worst = max(worst, err)
        say(f"kernel: ssd_scan B={B} S={S} H={H} p={p} N={N}: err / max "
            f"|plain| y {errs[0]:.2e} state {errs[1]:.2e} (tol {TOL_SSD:g})")

    B, S, H, p, N = SSD_CASES[0]
    x, dt, Bm, Cm, A = _ssd_inputs(B, S, H, p, N, gen, dev)
    h0 = torch.zeros((B, H, p, N), device=dev)
    ms = graph_time_ms(lambda: ssd_scan(x, dt, Bm, Cm, A), per_graph=20)
    plain_ms = graph_time_ms(lambda: ssd_chunked(x, dt, Bm, Cm, A, h0),
                             per_graph=5)
    eager_ms = cuda_time_ms(lambda: ssd_scan(x, dt, Bm, Cm, A), 100)
    nbytes = 4 * (2 * x.numel() + dt.numel() + Bm.numel() + Cm.numel()
                  + A.numel() + B * H * p * N)
    ops = _ssd_ops(B, S, H, p, N)
    bound_ms, bound_by = _bound(nbytes, ops, "float32")
    say(f"kernel: ssd_scan f32 B={B} S={S} H={H} p={p} N={N}, device time: "
        f"{ms * 1e3:.2f} us/launch; plain (chunked, PyTorch) "
        f"{plain_ms * 1e3:.2f} us; no single PyTorch call; bound "
        f"{bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} "
        f"GFLOP, {bound_by}); one eager call {eager_ms * 1e3:.2f} us")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:71",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _rel(a, b) -> float:
    """max |a − b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def phase_hybrid(dev) -> dict:
    """zamba2-2.7b at its published widths through generate: launch counts
    of the prefill, outputs, timings; prefill plus decode against forward
    at full depth (f32 and bf16); the card against the CPU at 6 layers."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build
    from repro_torch.models.hybrid import n_attn_sites
    from repro_torch.utils.params import strip_compute, with_compute_copies
    from repro_torch.utils.pytree import tree_map, tree_size

    cfg = get_config("zamba2-2.7b")
    widths = (cfg.d_model, cfg.n_layers, n_attn_sites(cfg), cfg.n_heads,
              cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
              cfg.ssm_heads, cfg.ssm_expand * cfg.d_model // cfg.ssm_heads,
              cfg.ssm_state, cfg.compute_dtype)
    if widths != (2560, 54, 9, 32, 32, 80, 10240, 32000, 80, 64, 64,
                  "bfloat16"):
        fail(f"unexpected zamba2-2.7b widths: {widths}")
    model = build(cfg)
    torch.cuda.synchronize()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tree_size(strip_compute(params))
    weights_mb = torch.cuda.memory_allocated() / 2 ** 20 - base_mb

    B, S0, steps = 4, 512, 16
    rng = np.random.default_rng(7)
    prompts = torch.from_numpy(rng.integers(4, cfg.vocab, (B, S0))).to(dev)
    temps = [0.0, 0.0, 0.8, 0.8]
    counters = (ssd_ops.LAUNCHES, fa_ops.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    out = generate(model, params, prompts, steps, temperature=temps, seed=11)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = {**ssd_ops.LAUNCHES, **fa_ops.LAUNCHES}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    want = {"ssd_scan": cfg.n_layers, "flash_attention_fwd": n_attn_sites(cfg)}
    if launches != want:
        fail(f"generate launched {launches}, expected {want} (one prefill)")
    if tuple(out.shape) != (B, S0 + steps) or not torch.equal(
            out[:, :S0], prompts):
        fail(f"generate returned {tuple(out.shape)} or changed the prompts")
    new = out[:, S0:]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
        fail(f"generated ids outside [0, {cfg.vocab})")
    say(f"hybrid: zamba2-2.7b d {cfg.d_model}, {cfg.n_layers} Mamba-2 layers"
        f" (H {cfg.ssm_heads} x p 64 x N {cfg.ssm_state}), "
        f"{n_attn_sites(cfg)} shared-attention sites ({cfg.n_heads} heads x "
        f"hd {cfg.head_dim}), d_ff {cfg.d_ff}, vocab {cfg.vocab}, bf16: "
        f"{n_params} parameters drawn on the card in {init_s:.2f} s "
        f"({weights_mb:.0f} MiB with the bf16 copies); generate {B} x "
        f"{S0} prompts + {steps} tokens (temperatures {temps}) in "
        f"{gen_s:.2f} s; launches {launches} (one per mixer, one per site); "
        f"peak device memory {peak_mb:.0f} MiB; first new tokens "
        f"{new[:, :4].tolist()}")

    # timings, none claimed
    batch = {"tokens": prompts}
    pre = lambda: model.prefill(params, batch, max_len=S0 + steps)  # noqa: E731
    pre_ms = cuda_time_ms(pre, 3, warmup=1)
    pre_dev, pre_wall, kernels = profiled_device_ms(pre, 2, top=None)
    share = {name: sum(ms for k, ms, _ in kernels if name in k)
             for name in ("ssd_scan_kernel", "flash_fwd_kernel")}
    _, cache = pre()
    tok = out[:, S0]
    dec = lambda: model.decode_step(params, tok, cache)  # noqa: E731
    dec_ms = cuda_time_ms(dec, 10, warmup=2)
    dec_dev, dec_wall, dec_top = profiled_device_ms(dec, 5, top=4)
    gen_dev, gen_wall, _ = profiled_device_ms(
        lambda: generate(model, params, prompts, steps, temperature=temps,
                         seed=11), 1, warmup=False, top=1)
    fmt_share = "not measured" if pre_dev is None else ", ".join(
        f"{k} {ms:.3f} ms ({100 * ms / pre_dev:.1f}%)"
        for k, ms in share.items())
    say(f"hybrid: prefill {B} x {S0} {pre_ms:.2f} ms eager "
        f"({B * S0 / pre_ms * 1e3:.0f} tokens/s), {_fmt_ms(pre_dev)} on the "
        f"device; kernels' device time per prefill: {fmt_share}; decode "
        f"step at B={B} {dec_ms:.2f} ms eager, {_fmt_ms(dec_dev)} on the "
        f"device ({B / dec_ms * 1e3:.0f} tokens/s); generate "
        f"{B * steps / gen_s:.1f} generated tokens/s with its prefill; "
        f"device busy "
        f"{'not measured' if gen_dev is None else f'{100 * gen_dev / gen_wall:.1f}%'}"
        f" of a profiled generate ({_fmt_ms(gen_dev)} of "
        f"{gen_wall:.1f} ms)")
    say("hybrid: device time of one prefill by kernel: " + "; ".join(
        f"{name} {ms * 1e3:.1f} us x{n:g}" for name, ms, n in kernels[:6]))
    say("hybrid: device time of one decode step by kernel: " + "; ".join(
        f"{name} {ms * 1e3:.1f} us x{n:g}" for name, ms, n in dec_top))
    del cache

    # prefill + decode against forward at full depth
    toks = torch.from_numpy(rng.integers(4, cfg.vocab, (2, 384))).to(dev)
    m32 = build(cfg.with_(compute_dtype="float32"))
    p32 = with_compute_copies(strip_compute(params), "float32",
                              m32.compute_copies)
    for dname, m, p in (("float32", m32, p32), ("bfloat16", model, params)):
        full = m.forward(p, {"tokens": toks})
        last, cache = m.prefill(p, {"tokens": toks[:, :256]}, max_len=512)
        errs = [_rel(last, full[:, 255])]
        for t in range(256, 259):
            lg, cache = m.decode_step(p, toks[:, t], cache)
            errs.append(_rel(lg, full[:, t]))
        del cache
        tol = TOL_HYBRID_CONSISTENT[dname]
        if not all(np.isfinite(errs)) or max(errs) > tol:
            fail(f"hybrid {dname}: prefill + decode disagree with forward: "
                 f"{errs} (tol {tol:g})")
        say(f"hybrid: {dname}, full depth, prefill of 256 + 3 decode steps "
            f"against forward over 384 tokens, B=2: max abs err / max "
            f"|logit| {', '.join(f'{e:.2e}' for e in errs)} (tol {tol:g})")
    del p32

    # the card's kernels against the CPU's plain versions: full width, the
    # first 6 layers and one site, float32, B 1, S 256
    small = build(cfg.with_(n_layers=6, compute_dtype="float32"))
    base = strip_compute(params)
    p6 = dict(base, mamba_layers=tree_map(lambda l: l[:6],
                                          base["mamba_layers"]))
    t1 = toks[:1, :256]
    for c in counters:
        for k in c:
            c[k] = 0
    lg_dev = small.forward(with_compute_copies(p6, "float32",
                                               small.compute_copies),
                           {"tokens": t1})
    torch.cuda.synchronize()
    dev_launches = {**ssd_ops.LAUNCHES, **fa_ops.LAUNCHES}
    if dev_launches != {"ssd_scan": 6, "flash_attention_fwd": 1}:
        fail(f"the 6-layer card forward launched {dev_launches}")
    t0 = time.perf_counter()
    lg_cpu = small.forward(with_compute_copies(
        tree_map(lambda l: l.cpu(), p6), "float32", small.compute_copies),
        {"tokens": t1.cpu()})
    cpu_s = time.perf_counter() - t0
    err = _rel(lg_dev.cpu(), lg_cpu)
    if not err <= TOL_HYBRID_CPU:
        fail(f"hybrid: card and CPU disagree at 6 layers: {err:.3e}")
    say(f"hybrid: card (ssd_scan, flash_attention_fwd) against CPU (plain "
        f"versions), full width, 6 layers, f32, B=1 S=256: max abs err / "
        f"max |logit| {err:.2e} (tol {TOL_HYBRID_CPU:g}); the CPU took "
        f"{cpu_s:.1f} s")
    del params, base, p6
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA GPU")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(src/repro_torch missing)")
    sys.path.insert(0, str(ROOT / "src"))
    # float32 products must run in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    phase_card()
    phase_build()
    fwd = phase_kernel(dev)
    bwd = phase_kernel_bwd(dev)
    clip_rows = phase_kernel_clip(dev)
    flash = phase_kernel_flash(dev)
    ssd = phase_kernel_ssd(dev)
    serve = phase_serve(dev, fwd)
    train = phase_train(dev)
    bwd["launches"] = phase_decode_grad(dev)
    fwd["launches"] = serve["launches"] + train["launches"]["cifg_cell_fwd"]
    say(f"launches of cifg_cell_fwd: serve {serve['launches']}, train "
        f"{train['launches']['cifg_cell_fwd']}")
    for row in clip_rows:
        row["launches"] = train["launches"][row["name"]]
    hybrid = phase_hybrid(dev)
    for row in (flash, ssd):
        row["launches"] = hybrid[row["name"]]
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    if leaked:
        fail(f"imported modules of JAX or the JAX package: {leaked[:5]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(json.dumps({"kernels": [{k: row[k] for k in keys}
                                 for row in (fwd, bwd, *clip_rows, flash,
                                             ssd)]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
