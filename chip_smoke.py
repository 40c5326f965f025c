#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (built for an H100, ``sm_90a``) and ``nvcc``; run from the
root of a checkout. Imports nothing of JAX or of the JAX package. Phases, one
line each (any failure exits non-zero and prints no result):

1. card  — name and power limit, as ``nvidia-smi`` reports them;
2. build — compiles every kernel from the checkout's sources;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card, at the shapes the serving path gives it, then timed against its
   bound, the plain version and a PyTorch yardstick;
4. serve — the paper's CIFG-LSTM at its published widths (vocab 10000,
   d 96, H 256, bf16) through ``ServeEngine``: ~512 sessions, a hot-swap,
   launch counts of every kernel on prefill and decode, token-for-token
   agreement with ``reference_generate`` on sampled sessions.

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
    kernel = phase_kernel(dev)
    serve = phase_serve(dev, kernel)
    kernel["launches"] = serve["launches"]
    leaked = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    if leaked:
        fail(f"imported modules of JAX or the JAX package: {leaked[:5]}")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    say(json.dumps({"kernels": [{k: kernel[k] for k in keys}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
