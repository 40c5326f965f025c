#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA GPU (built for an H100, ``sm_90a``) and ``nvcc``; run from the
root of a checkout. Imports nothing of JAX or of the JAX package. Phases, one
line each (any failure exits non-zero and prints no result):

1. card  — name and power limit, as ``nvidia-smi`` reports them;
2. build — compiles every kernel from the checkout's sources;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   card (``cifg_cell_fwd`` at H up to 520, both of its routes;
   ``cifg_cell_bwd``, the per-step form and the sequence form
   ``cifg_cell_bwd_seq``; both cell kernels with a client axis, chunks of
   16 and 19 clients, each client bitwise its one-client launch, with the
   clusters the card holds at once; ``dp_sumsq``, one leaf and a chunk of
   clients;
   ``dp_clip_accumulate``, ``flash_attention_fwd``, ``ssd_scan``, also
   with one A per batch row at a chunk of mamba2-370m clients), at the
   shapes its path gives it and around them, then timed against its bound,
   the plain version and one PyTorch call where there is one;
4. serve — the paper's CIFG-LSTM at its published widths (vocab 10000,
   d 96, H 256, bf16) through ``ServeEngine``: ~512 sessions, a hot-swap,
   launch counts of every kernel on prefill and decode, token-for-token
   agreement with ``reference_generate`` on sampled sessions;
5. train — DP-FedAvg of the same model through ``FederatedTrainer``
   (host backend): 1000 users, cohort 128, 3 rounds; launch counts (one
   forward and one backward cell launch per chunk of clients and local
   batch — the chunk trains as one batched program —, one sum-of-squares
   launch per chunk), the fused path against the plain one on one round,
   the round sum bitwise across cohort chunks, the noise's std, rounds/s
   and where a round's time goes (a client step and a chunk's clip with and
   without the sequence backward and the chunked sum of squares; a chunk
   of 16 clients one after another, as 16
   calls of ``local_delta`` and as one ``local_deltas``, bitwise and timed;
   rounds/s with the chunk batched and not, all in turns in the same run);
   then the training CLI on a tiny run;
6. grad through decode — the gradient of a loss through 4 ``decode_step``
   calls, through the backward cell kernel, against plain autograd;
7. hybrid serve — ``zamba2-2.7b`` at its published widths (54 Mamba-2
   layers, 9 shared-attention sites, bf16) with random weights from a seed
   through ``generate``: 4 prompts of 512 tokens, 16 decode steps, half
   greedy and half sampled; one ``ssd_scan`` launch per mixer and one
   ``flash_attention_fwd`` launch per site in the prefill; prefill plus
   decode against ``forward`` at full depth; the card's kernels against the
   CPU's plain versions at full width and 6 layers; timings;
8. memorize — the Secret Sharer on the same CIFG-LSTM: 1000 users and the
   paper's 27 canaries (189 synthetic devices) trained 10 rounds at cohort
   128 through ``FederatedTrainer(backend="engine")`` with the canary eval
   hook every 5 rounds, then Random-Sampling ranks at |R| = 2.5·10⁵ and
   beam-search extraction of every canary; the engine's ``run`` against
   ``run_python`` and against the host trainer on its draws (bitwise), the
   round across cohort chunks (bitwise), the noise's std, launch counts,
   and scores, RS ranks on a pool and the top-5 beams card against CPU;
9. faults — the production round protocol on the same CIFG-LSTM at full
   width: 1000 users, target cohort 128, ``FaultConfig(seed=7,
   dropout_prob=0.1, straggler_prob=0.2, straggler_mean_delay=1.0,
   round_deadline=3.0, corrupt_prob=0.05)``, 10 rounds through
   ``FederatedTrainer(backend="engine", fault_config=...)``: 152 selected a
   round, the reported count and the guard's rejections equal to the fates
   drawn again on the host, launches of the four training kernels equal to
   what the report masks predict, σ = zS/103; a run with report goal 150
   whose aborted rounds change no bit and no accountant step; a fault-on
   round on the card against the CPU on one stream of draws; a run-state
   save and restore bitwise against the uninterrupted run; the training
   CLI's ``--crash-after`` then ``--resume`` at full width in subprocesses
   with no ``msgpack`` importable, sha256-equal final checkpoints; rounds/s
   (its profiled round was cut to make room for phase 15);
10. fleet — the paper's fleet on the card: the same CIFG-LSTM at full width
   trained over N = 4·10⁶ users through the streamed population backend
   (the Train corpus written by ``repro_torch.launch.build_corpus``, opened
   memory-mapped, replicated to N) and the block-keyed sharded sampler:
   the streamed backend bitwise the device backend at N = 1000 (both
   samplers; fixed, Poisson and faulty rounds; in-memory and mmap stores;
   ``run`` and ``run_python``), the sharded cohorts on the card equal to
   the CPU's at N, the corpus bytes on the card equal at both N, 10
   rounds through ``FederatedTrainer`` with a read every 5 rounds and 10
   with a read every round (bitwise equal; launches exact), the sample phase per
   sampler, the busy share of one round, the training CLI over the store
   crashed and resumed (sha256-equal);
11. decoder serve — granite-3-2b (dense, GQA 32/8 at hd 64) and
   olmoe-1b-7b (MoE, 64 experts top-8, hd 128) at their published widths
   and full depth, bf16, random weights from a seed, through ``generate``:
   4 prompts of 512 tokens, 16 decode steps, half greedy and half sampled;
   one ``flash_attention_fwd`` launch per layer in the prefill, all on the
   tensor cores, none in the decode steps; the MoE prefill's dropped pairs
   counted; prefill plus decode against ``forward`` at full depth (f32 and
   bf16); timings; then all six decoder configs (phi3-mini's hd 96,
   phi3-medium's GQA 40/10 at hd 128, stablelm-12b's hd 160 also in bf16
   on the wide route) card against CPU at full width and 2 layers, the
   MoE's top-k sets compared token by token (a difference must be a near
   tie). Runs after phase 7;
12. encdec and vlm serve — whisper-small at its published widths and
   depth (12 + 12 layers, d 768, 12 x hd 64, bf16, random weights from a
   seed): 4 clips of 1,500 frame embeddings and a 64-token prompt through
   ``model.prefill`` (exactly 36 flash launches, all on the tensor cores:
   the encoder's 12 bidirectional ones at Sq = Sk = 1,500, 12 causal, 12
   cross-attentions at Sq 64, Sk 1,500), 16 greedy ``decode_step``s (none);
   prefill plus 3 decode steps against forward (f32 and bf16); card against
   CPU at full depth in f32; timings; then chameleon-34b at full width and
   1 layer with 1,024 image embeddings, card against CPU in f32;
13. every family trains — granite-3-2b, olmoe-1b-7b, mamba2-370m,
   zamba2-2.7b, whisper-small and chameleon-34b at full width (depth cut
   as ``TRAIN_FAMILIES`` says): one ``user_update`` each in f32, card
   against CPU (loss, Δ, norm, clip flag), with exactly 2 flash launches
   per attention and 2 SSD launches per mixer (the forward and the remat
   recomputation; the backward is the plain version's gradient); a bf16
   DP-FedAvg round of 4 clients trained as one chunk (``local_deltas``,
   2 flash launches per attention and 2 SSD launches per mixer for the
   whole round), clipped and summed as the round does, with its noise
   std, every client's Δ and loss bitwise at C 1 and at C 2 in the other
   position; mamba2-370m and whisper-small uncut, a chunk of 4 against the
   one-client loop (f32 within ``TOL_TRAIN``, then bf16 timed in turns);
   one ``user_update`` of granite-3-2b at full depth (peak memory, step
   time); the training CLI on granite-3-2b and zamba2-2.7b reduced, 32
   clients a round in chunks of 4, launches exact per chunk;
14. shards — the cohort sharded over ranks on one card: the paper's model
   at full width, cohort 128, z 0.3, S 0.8, 3 rounds, through
   ``SimEngine(num_shards=S, num_pods=P)`` on ranks that share the card
   on gloo (NCCL refuses two ranks on one device), started by
   ``launch.mesh.spawn_ranks`` after the kernels are built: the device
   backend at N = 1000 (global sampler, fixed rounds) at (P, S) = (1, 2),
   (1, 4) and (2, 2), Poisson rounds with the fault model at (1, 4), and
   the fleet (N = 4·10⁶, streamed backend, sharded sampler) at (2, 2),
   each bitwise the one-rank run (params, momentum, population vectors,
   history, the cohort ids of every round) with every kernel's launches
   summed over the ranks equal to the one rank's; rounds/s, the gathers'
   bytes and time a round, the card's busy share and the population bytes
   a rank; then the training CLI under ``python -m torch.distributed.run
   --nproc-per-node 4 ... --num-shards 4 --dist-backend gloo``,
   uninterrupted and crashed after round 2 then resumed, sha256-equal to
   one rank. Runs after phase 10;
15. production — the production step (``repro_torch.launch.steps``) on
   DTensor over the (data, model) mesh, one gloo rank at (1, 1):
   ``make_fed_train_step`` of granite-3-2b (40 layers) and mamba2-370m (48)
   uncut, 4 clients, and the CIFG-LSTM at its published widths, 16
   clients, each × 4,096 tokens, z 0.3, S 0.8, with exactly 2 flash
   launches per attention layer per client (320), 2 ``ssd_scan`` per mixer
   per client (384) and one ``cifg_cell_fwd`` and one
   ``cifg_cell_bwd_seq`` per client, step time and peak memory; at 2
   layers and 512 tokens (the LSTM whole) bitwise the mesh-free
   computation (``steps.fed_train_step_plain``); the noise's std within 2%
   of zS/C, params moved, count 1; the card against the CPU at 2 layers, 2
   clients × 256; granite-3-2b's prefill step at B 1 × 32,768 (one flash
   launch a layer) and 3 decode steps at B 4 against a 32,768-slot cache,
   timed, after the (1, 1) serving steps bitwise the unsharded ones at
   2,048 tokens; then 4 gloo ranks sharing the card at (2, 2) and
   (2, 1, 2) against (1, 1) (granite-3-2b at full width, 1 layer, 2
   clients × 64, z 0), and a planted fault (batch row 1's clients dropped
   at (2, 2)) that the same comparison must catch.
   Runs after phase 14.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS_PER_S = {"bfloat16": 989e12,      # dense tensor-core rate
                  "float32": 67e12,        # outside the tensor cores
                  # float32 products as three TF32 products (3xTF32) at
                  # the tensor cores' 495 TFLOP/s in TF32
                  "float32_3xtf32": 495e12 / 3}

# tolerances of kernel vs plain over 16 chained steps: float32 differs only
# in the order of the sum; bfloat16 can flip the rounding of h by one ulp
# (~4e-3 relative) at the next step, which then propagates
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 0.0)}  # (atol, rtol)
# the backward cell: float32 differs in the order of sums of up to 768
# terms; in bfloat16 a one-ulp difference in z can flip the rounding of a
# dz entry before the products
TOL_BWD = {"float32": (1e-5, 1e-4), "bfloat16": (3e-2, 0.0)}
# the sequence backward (float32 throughout) against its plain loop: the
# order of the product's sums and the last bit of exp and tanh differ, over
# 16 reverse steps (atol, rtol)
TOL_BWD_SEQ = (1e-5, 1e-4)
# the chunked sum of squares against the plain float32 sums (rtol)
TOL_SUMSQ = 1e-5
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


# the card's name and power limit as nvidia-smi gives them (`phase_card`),
# named beside the times that a phase prints
CARD = "card not read"


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


def fwd_bwd_ms(fn, inputs, iters: int = 20) -> tuple:
    """Eager time of ``fn(*inputs)`` alone and with the gradient of all
    its outputs against fixed cotangents, each from CUDA events around
    ``iters`` calls: (forward ms, forward + backward ms)."""
    import torch

    ins = [t.detach().requires_grad_(True) for t in inputs]
    with torch.no_grad():
        outs = fn(*ins)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.randn_like(o) for o in outs]

    def step():
        o = fn(*ins)
        torch.autograd.grad(o if isinstance(o, tuple) else (o,), ins, cots)
    return cuda_time_ms(lambda: fn(*ins), iters), cuda_time_ms(step, iters)


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
    global CARD
    CARD = line
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


def _cell_inputs(B, H, gen, dev, S=16):
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return (randn(S, B, 3 * H), randn(B, H, scale=0.3),
            randn(B, H, scale=0.3), randn(H, 3 * H, scale=H ** -0.5))


# the cell kernel's main-path shapes (B, S): a serving decode tick, a
# training client batch, an admission prefill of a 16-token prompt, a
# Random-Sampling chunk of the Secret Sharer (27 canaries x 1024
# continuations of 5 words) and the last step of its beam search
CELL_SHAPES = (("decode", 256, 1), ("train", 10, 16), ("prefill", 1, 16),
               ("rs", 27648, 5), ("beam", 5, 4))

# the Secret Sharer's shapes (B, S): an RS chunk, the beam-search steps
MEMORIZE_SHAPES = ((27648, 5), (1, 2), (5, 3), (5, 4))


# the cell kernels' widths: the 8-CTA route (H <= 256) and the wide route,
# w_h resident (264) and streamed (520)
CELL_WIDTHS = (64, 200, 256, 264, 520)


def _addmm_loop(zx, h0, c0, w):
    """The PyTorch yardstick of the cell kernel: S × (``addmm`` in the
    compute dtype's values, f32 sums, + the gates) → a function of no
    arguments returning (h, c); with a client axis (zx (C, S, B, 3H)) S ×
    ``baddbmm``."""
    import torch

    from repro_torch.utils.numerics import round_to

    S, H, cd = zx.shape[-3], h0.shape[-1], w.dtype
    w32 = round_to(w, cd)
    mm = torch.baddbmm if zx.dim() == 4 else torch.addmm

    def loop():
        h, c = h0, c0
        for t in range(S):
            z = mm(zx[..., t, :, :], round_to(h, cd), w32)
            f = torch.sigmoid(z[..., :H] + 1.0)
            o = torch.sigmoid(z[..., H:2 * H])
            g = torch.tanh(z[..., 2 * H:])
            c = f * c + (1.0 - f) * g
            h = o * torch.tanh(c)
        return h, c
    return loop


def phase_kernel(dev) -> dict:
    """cifg_cell_fwd (one launch per sequence) vs the plain recurrence on
    the card: bf16 and f32, B 1, 3, 10, 256 x H 64, 200, 256, 264, 520
    (ragged; both routes), 16 steps; bitwise: rows independent of B and
    position, the prefix property and S = 1 chaining; timings at the
    decode, training and prefill shapes, and of the wide route."""
    import torch

    from repro_torch.kernels.cifg_cell import (cell_fwd, cell_seq_fwd,
                                               cifg_cell_ref, cifg_states)

    gen = torch.Generator().manual_seed(1234)
    worst = 0.0
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL[name]
        for B in (1, 3, 10, 256):
            for H in CELL_WIDTHS:
                zxs, h0, c0, w = _cell_inputs(B, H, gen, dev)
                w = w.to(cd)
                hk, ck = cell_seq_fwd(zxs, h0, c0, w)
                hr, cr = cifg_states(zxs, h0, c0, w, cell="seq")
                torch.cuda.synchronize()
                for what, a, b in (("h", hk, hr), ("c", ck, cr)):
                    if not bool(torch.isfinite(a).all()):
                        fail(f"kernel {what} not finite ({name} B={B} H={H})")
                    if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                        fail(f"kernel disagrees with plain ({name} B={B} "
                             f"H={H}): max abs err "
                             f"{float((a - b).abs().max()):.3e}")
                err_h = float((hk - hr).abs().max())
                err_c = float((ck - cr).abs().max())
                worst = max(worst, err_h, err_c)
                # the prefix property and S = 1 chaining, bit for bit
                for t in (0, 4, 15):
                    hp, cp = cell_seq_fwd(zxs[:t + 1].contiguous(), h0, c0, w)
                    if not (torch.equal(hp[-1], hk[t])
                            and torch.equal(cp[-1], ck[t])):
                        fail(f"kernel prefix property broken at step {t} "
                             f"({name} B={B} H={H})")
                h, c = h0, c0
                for t in range(16):
                    h, c = cell_fwd(zxs[t], h, c, w)
                if not (torch.equal(h, hk[-1]) and torch.equal(c, ck[-1])):
                    fail(f"16 chained one-step launches differ from one "
                         f"16-step launch ({name} B={B} H={H})")
                say(f"kernel: cifg_cell_fwd {name} B={B} H={H} 16 steps in "
                    f"one launch: max abs err h {err_h:.3e} c {err_c:.3e} "
                    f"(tol atol {atol:g} rtol {rtol:g}); prefix and 16 "
                    f"chained S=1 launches bitwise equal")

    # the engine (B = slots) must match the reference (B = 1) bit for bit
    for cd in (torch.bfloat16, torch.float32):
        for H in (256, 264, 520):
            zxs, h0, c0, w = _cell_inputs(256, H, gen, dev)
            w = w.to(cd)
            hb, cb = cell_seq_fwd(zxs, h0, c0, w)
            for r in (0, 17, 255):
                h1, c1 = cell_seq_fwd(zxs[:, r:r + 1].contiguous(),
                                      h0[r:r + 1].contiguous(),
                                      c0[r:r + 1].contiguous(), w)
                if not (torch.equal(h1[:, 0], hb[:, r])
                        and torch.equal(c1[:, 0], cb[:, r])):
                    fail(f"kernel row {r} differs between B=256 and B=1 "
                         f"({cd}, H={H})")
    say("kernel: rows of B=256 are bitwise those of B=1 over 16 steps, bf16 "
        "and f32, H 256, 264 and 520")
    # the Secret Sharer's shapes at H 256: against the plain recurrence, and
    # rows of the RS chunk bitwise those of B = 1
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL[name]
        for B, S in MEMORIZE_SHAPES:
            zxs, h0, c0, w = _cell_inputs(B, 256, gen, dev, S=S)
            w = w.to(cd)
            hk, ck = cell_seq_fwd(zxs, h0, c0, w)
            hr, cr = cifg_states(zxs, h0, c0, w, cell="seq")
            torch.cuda.synchronize()
            for what, a, b in (("h", hk, hr), ("c", ck, cr)):
                if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                    fail(f"kernel disagrees with plain ({name} B={B} S={S} "
                         f"H=256): max abs err "
                         f"{float((a - b).abs().max()):.3e}")
            worst = max(worst, float((hk - hr).abs().max()),
                        float((ck - cr).abs().max()))
            for r in ((0, B // 2, B - 1) if B > 1 else ()):
                h1, c1 = cell_seq_fwd(zxs[:, r:r + 1].contiguous(),
                                      h0[r:r + 1].contiguous(),
                                      c0[r:r + 1].contiguous(), w)
                if not (torch.equal(h1[:, 0], hk[:, r])
                        and torch.equal(c1[:, 0], ck[:, r])):
                    fail(f"kernel row {r} differs between B={B} and B=1 "
                         f"({name}, S={S})")
            say(f"kernel: cifg_cell_fwd {name} B={B} S={S} H=256 (the Secret "
                f"Sharer's shape) against plain: max abs err h "
                f"{float((hk - hr).abs().max()):.3e} c "
                f"{float((ck - cr).abs().max()):.3e}; rows bitwise those of "
                f"B=1")

    # timings at the main path's shapes: device time (CUDA graph) of the
    # kernel, of its plain version and of the PyTorch yardstick (S x addmm
    # + gates); then one eager call through the wrapper
    H, cd = 256, torch.bfloat16
    rows = {}
    for what, B, S in CELL_SHAPES:
        zx, h0, c0, w = _cell_inputs(B, H, gen, dev, S=S)
        w = w.to(cd)
        hs = torch.empty((S, B, H), device=dev)
        cs = torch.empty_like(hs)
        library = _addmm_loop(zx, h0, c0, w)

        def plain():
            h, c = h0, c0
            for t in range(S):
                h, c = cifg_cell_ref(zx[t], h, c, w)
            return h, c

        ms = graph_time_ms(lambda: cell_seq_fwd(zx, h0, c0, w, hs=hs, cs=cs))
        plain_ms = graph_time_ms(plain, per_graph=max(1, 50 // S))
        library_ms = graph_time_ms(library, per_graph=max(1, 50 // S))
        eager_ms = cuda_time_ms(lambda: cell_seq_fwd(zx, h0, c0, w, hs=hs,
                                                     cs=cs), 1000)
        nbytes = (zx.numel() + 2 * B * H + 2 * S * B * H) * 4 \
            + w.numel() * w.element_size()
        ops = 2 * S * B * H * 3 * H
        bound_ms, bound_by = _bound(nbytes, ops, "bfloat16")
        rows[what] = {"ms": ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        say(f"kernel: cifg_cell_fwd bf16 {what} B={B} S={S} H={H}, device "
            f"time: {ms * 1e3:.2f} us/launch ({ms * 1e3 / S:.2f} us a step); "
            f"plain {plain_ms * 1e3:.2f} us; {S} x (addmm + gates) "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP, {bound_by}); one "
            f"eager call {eager_ms * 1e3:.2f} us")
    # the wide route at the training shape, informational: H 264 (w_h
    # resident, 16-CTA clusters) and 520 (streamed)
    for H in (264, 520):
        zx, h0, c0, w = _cell_inputs(10, H, gen, dev, S=16)
        w = w.to(torch.bfloat16)

        def plain():
            h, c = h0, c0
            for t in range(16):
                h, c = cifg_cell_ref(zx[t], h, c, w)
            return h, c

        ms = graph_time_ms(lambda: cell_seq_fwd(zx, h0, c0, w))
        plain_ms = graph_time_ms(plain, per_graph=3)
        library_ms = graph_time_ms(_addmm_loop(zx, h0, c0, w), per_graph=3)
        nbytes = (zx.numel() + 2 * 10 * H + 2 * 16 * 10 * H) * 4 \
            + w.numel() * 2
        bound_ms, bound_by = _bound(nbytes, 2 * 16 * 10 * H * 3 * H,
                                    "bfloat16")
        say(f"kernel: cifg_cell_fwd bf16 wide route "
            f"({'resident' if H <= 512 else 'streamed'} w_h) B=10 S=16 "
            f"H={H}, device time: {ms * 1e3:.2f} us/launch; plain "
            f"{plain_ms * 1e3:.2f} us; 16 x (addmm + gates) "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
            f"({bound_by})")
    for cd in (torch.bfloat16, torch.float32):
        zx, h0, c0, w = _cell_inputs(256, 256, gen, dev, S=1)
        w = w.to(cd)
        res = kernel_resources(lambda: cell_seq_fwd(zx, h0, c0, w),
                               "cifg_seq_kernel")
        say(f"kernel: cifg_cell_fwd {str(cd).split('.')[-1]} (clusters of "
            f"8), from the profiler's trace: {res}")
    # the row of the kernels line: the decode tick's shape, as before
    return {"name": "cifg_cell_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/cifg_cell/csrc/cifg_cell_fwd.cu",
            "replaces": "src/repro/kernels/cifg_cell/cifg_cell.py:77",
            "max_abs_err": worst, **rows["decode"]}


def _counting(fn, counts: dict, key: str, launches: dict):
    """Wrap a model entry point: add the kernel launches made inside each
    call to ``counts[key]`` and the calls to ``counts[key + "_calls"]``."""
    def wrapped(*args, **kw):
        before = launches["cifg_cell_fwd"]
        out = fn(*args, **kw)
        counts[key] += launches["cifg_cell_fwd"] - before
        counts[key + "_calls"] += 1
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
    counts = {"prefill": 0, "decode": 0, "prefill_calls": 0,
              "decode_calls": 0}
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

    # one launch per prefill (the whole prompt) and per decode tick
    if counts["prefill"] <= 0 or counts["decode"] <= 0 \
            or counts["prefill"] != counts["prefill_calls"] \
            or counts["decode"] != counts["decode_calls"]:
        fail(f"cell kernel not launched once per prefill and per decode "
             f"step: {counts}")
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
        f"prefill {counts['prefill']} (1 per prefill call) decode "
        f"{counts['decode']} (1 per tick); swap at tick {swap_tick}, {straddled} sessions crossed "
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


def _bound(nbytes: float, ops, dtype: str | None = None):
    """(bound_ms, bound_by) of work moving ``nbytes`` and doing ``ops`` at
    ``dtype``'s peak rate; or, with no ``dtype``, ``ops`` maps each rate of
    ``PEAK_OPS_PER_S`` to the operations done at it, and their times add."""
    if dtype is not None:
        ops = {dtype: ops}
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _bwd_inputs(B, H, gen, dev, cd):
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return (randn(B, 3 * H), randn(H, 3 * H, scale=H ** -0.5).to(cd),
            randn(B, H, scale=0.3), randn(B, H, scale=0.3),
            randn(B, H, scale=0.1), randn(B, H, scale=0.1))


def phase_kernel_bwd(dev, B_main: int = 10) -> None:
    """cifg_cell_bwd (the per-step form, cifg_step's gradient) vs
    cell_bwd_ref on the card: bf16 and f32, B 1, 10, 256 × H 64, 200, 256,
    264, 520, all four outputs; repeatability; timings at the
    decode-gradient shape (B_main, H 256, bf16) and at B=256, printed (the
    kernels line reports the sequence form)."""
    import torch

    from repro_torch.kernels.cifg_cell import cell_bwd, cell_bwd_ref
    from repro_torch.utils.numerics import round_to

    gen = torch.Generator().manual_seed(4321)
    worst = 0.0
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL_BWD[name]
        for B in (1, 10, 256):
            for H in CELL_WIDTHS:
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
        say(f"kernel: cifg_cell_bwd (per step) bf16 B={B} H={H}, device "
            f"time: {ms * 1e3:.2f} us/launch (4 kernels); plain "
            f"{plain_ms * 1e3:.2f} us; cuBLAS products + elementwise "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
            f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, {bound_by}); "
            f"one eager call {eager_ms * 1e3:.2f} us; worst max abs err "
            f"{worst:.2e}")


def _bwd_seq_inputs(S, B, H, gen, dev):
    import torch

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    return (randn(S, B, 3 * H), randn(S, B, H, scale=0.3),
            randn(B, H, scale=0.3), randn(S, B, H, scale=0.1),
            randn(B, H, scale=0.1), randn(B, H, scale=0.1),
            randn(H, 3 * H, scale=H ** -0.5))


def _bwd_seq_bound(S, B, H):
    """(bound_ms, bound_by, MB, GFLOP) of cell_bwd_seq at (S, B, H): z, cs,
    c0, dhs, dh_fin, dc_fin and w_h read once, dz, dh0 and dc0 written once;
    the f32 products plus about 30 operations a (step, row, column) for the
    elementwise step (exp and tanh counted as one), at the CUDA cores'
    float32 rate."""
    nbytes = 4 * (2 * S * B * 3 * H + 2 * S * B * H + 5 * B * H + 3 * H * H)
    ops = 2 * S * B * H * 3 * H + 30 * S * B * H
    bound_ms, bound_by = _bound(nbytes, ops, "float32")
    return bound_ms, bound_by, nbytes / 1e6, ops / 1e9


def _reverse_loop(z, cs, c0, dhs, dhf, dcf, w):
    """The reverse recursion as training ran it before the sequence kernel:
    the factors precomputed, then S × (elementwise + f32 ``torch.mm``) →
    a function of no arguments returning (dh0, dc0); with a client axis
    (z (C, S, B, 3H)) S × ``torch.bmm``."""
    import torch

    S, H = z.shape[-3], w.shape[-2]
    f = torch.sigmoid(z[..., :H] + 1.0)
    o = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:])
    t = torch.tanh(cs)
    c_prev = torch.cat([c0.unsqueeze(-3), cs[..., :-1, :, :]], dim=-3)
    A, Bf = o * (1.0 - t * t), (c_prev - g) * f * (1.0 - f)
    Co, Dg = t * o * (1.0 - o), (1.0 - f) * (1.0 - g * g)
    w_t = w.transpose(-1, -2)
    mm = torch.bmm if z.dim() == 4 else torch.mm
    dz = torch.empty_like(z)

    def loop():
        dh_next, dc_next = dhf, dcf
        for s in range(S - 1, -1, -1):
            at = (Ellipsis, s, slice(None), slice(None))
            dh = dh_next + dhs[at]
            dct = dc_next + dh * A[at]
            torch.mul(dct, Bf[at], out=dz[..., s, :, :H])
            torch.mul(dh, Co[at], out=dz[..., s, :, H:2 * H])
            torch.mul(dct, Dg[at], out=dz[..., s, :, 2 * H:])
            dh_next = mm(dz[at], w_t)
            dc_next = dct * f[at]
        return dh_next, dc_next
    return loop


def phase_kernel_bwd_seq(dev) -> dict:
    """cifg_cell_bwd_seq (the reverse recursion of a sequence in one
    launch) vs its plain loop on the card: B 1, 10, 256 × H 64, 200, 256,
    264, 520 × S 1, 16, all three outputs, bitwise repeatable; a row does
    not depend on B; cifg_sequence(cell="fused") takes one launch per
    backward in bf16 and f32 compute, remat bitwise; timed at the training
    shape (B 10, S 16, H 256) against its bound, the plain version and the
    reverse loop as training ran it before (16 × (elementwise + f32
    torch.mm)), the library yardstick; the wide route at H 264 and 520
    against the same two."""
    import torch

    from repro_torch.kernels.cifg_cell import (LAUNCHES, cell_bwd_seq,
                                               cell_bwd_seq_ref,
                                               cifg_sequence)

    gen = torch.Generator().manual_seed(8765)
    atol, rtol = TOL_BWD_SEQ
    worst = 0.0
    for S in (1, 16):
        for B in (1, 10, 256):
            for H in CELL_WIDTHS:
                args = _bwd_seq_inputs(S, B, H, gen, dev)
                got = cell_bwd_seq(*args)
                want = cell_bwd_seq_ref(*args)
                torch.cuda.synchronize()
                errs = []
                for what, a, b in zip(("dz", "dh0", "dc0"), got, want):
                    if a.shape != b.shape or not bool(torch.isfinite(a).all()):
                        fail(f"cifg_cell_bwd_seq {what} bad (S={S} B={B} "
                             f"H={H})")
                    if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                        fail(f"cifg_cell_bwd_seq {what} disagrees with plain "
                             f"(S={S} B={B} H={H}): max abs err "
                             f"{float((a - b).abs().max()):.3e}")
                    errs.append(float((a - b).abs().max()))
                if not all(torch.equal(a, b)
                           for a, b in zip(got, cell_bwd_seq(*args))):
                    fail(f"cifg_cell_bwd_seq not repeatable (S={S} B={B} "
                         f"H={H})")
                if B == 256:
                    z, cs, c0, dhs, dhf, dcf, w = args
                    for r in (0, 255):
                        col = lambda t: t[:, r:r + 1].contiguous()  # noqa
                        row = lambda t: t[r:r + 1].contiguous()  # noqa
                        one = cell_bwd_seq(col(z), col(cs), row(c0),
                                           col(dhs), row(dhf), row(dcf), w)
                        if not (torch.equal(one[0][:, 0], got[0][:, r])
                                and torch.equal(one[1][0], got[1][r])
                                and torch.equal(one[2][0], got[2][r])):
                            fail(f"cifg_cell_bwd_seq row {r} differs between "
                                 f"B=256 and B=1 (S={S} H={H})")
                worst = max(worst, *errs)
                say(f"kernel: cifg_cell_bwd_seq S={S} B={B} H={H}: max abs "
                    f"err dz {errs[0]:.2e} dh0 {errs[1]:.2e} dc0 "
                    f"{errs[2]:.2e} (tol atol {atol:g} rtol {rtol:g}); "
                    f"bitwise repeatable"
                    + ("; rows of B=256 bitwise B=1" if B == 256 else ""))

    # the training op: one launch per backward, remat bitwise
    for cd in ("bfloat16", "float32"):
        for H in (256, 264):
            zx, h0, c0, w = _cell_inputs(10, H, gen, dev, S=16)

            def grads(remat):
                a = [t.clone().requires_grad_(True) for t in (zx, h0, c0, w)]
                hs, (hf, cf) = cifg_sequence(*a, cell="fused",
                                             compute_dtype=cd, remat=remat)
                return torch.autograd.grad((hs * hs).sum() + (hf * cf).sum(),
                                           a)

            before = LAUNCHES["cifg_cell_bwd_seq"]
            g = grads(False)
            torch.cuda.synchronize()
            if LAUNCHES["cifg_cell_bwd_seq"] != before + 1:
                fail(f"cifg_sequence's backward launched cifg_cell_bwd_seq "
                     f"{LAUNCHES['cifg_cell_bwd_seq'] - before} times")
            if not all(torch.equal(a, b) for a, b in zip(g, grads(True))):
                fail(f"cifg_sequence gradients differ with remat ({cd} "
                     f"H={H})")
    say("kernel: cifg_sequence(cell=fused) backward: one cifg_cell_bwd_seq "
        "launch per call, remat bitwise, bf16 and f32 compute, H 256 and 264")

    S, B, H = 16, 10, 256
    args = _bwd_seq_inputs(S, B, H, gen, dev)
    library = _reverse_loop(*args)
    ms = graph_time_ms(lambda: cell_bwd_seq(*args))
    plain_ms = graph_time_ms(lambda: cell_bwd_seq_ref(*args), per_graph=3)
    library_ms = graph_time_ms(library, per_graph=3)
    eager_ms = cuda_time_ms(lambda: cell_bwd_seq(*args), 1000)
    library_eager = cuda_time_ms(library, 100)
    bound_ms, bound_by, mb, gflop = _bwd_seq_bound(S, B, H)
    say(f"kernel: cifg_cell_bwd_seq f32 training shape S={S} B={B} H={H}, "
        f"device time: {ms * 1e3:.2f} us/launch ({ms * 1e3 / S:.2f} us a "
        f"step); plain {plain_ms * 1e3:.2f} us; the reverse loop (16 x "
        f"elementwise + torch.mm) {library_ms * 1e3:.2f} us on the device, "
        f"{library_eager * 1e3:.2f} us eager; bound {bound_ms * 1e3:.3f} us "
        f"({mb:.2f} MB, {gflop:.4f} GFLOP, {bound_by}); one eager call "
        f"{eager_ms * 1e3:.2f} us")
    for H in (264, 520):
        a = _bwd_seq_inputs(S, B, H, gen, dev)
        wide_ms = graph_time_ms(lambda: cell_bwd_seq(*a))
        wide_plain = graph_time_ms(lambda: cell_bwd_seq_ref(*a), per_graph=3)
        wide_loop = graph_time_ms(_reverse_loop(*a), per_graph=3)
        wb, wby, _, _ = _bwd_seq_bound(S, B, H)
        say(f"kernel: cifg_cell_bwd_seq wide route "
            f"({'resident' if H <= 512 else 'streamed'} w_h) S={S} B={B} "
            f"H={H}, device time: {wide_ms * 1e3:.2f} us/launch; plain "
            f"{wide_plain * 1e3:.2f} us; the reverse loop "
            f"{wide_loop * 1e3:.2f} us; bound {wb * 1e3:.3f} us ({wby})")
    a = _bwd_seq_inputs(S, 256, 256, gen, dev)
    res = kernel_resources(lambda: cell_bwd_seq(*a), "cifg_bwd_seq_kernel")
    say(f"kernel: cifg_cell_bwd_seq (clusters of 8), from the profiler's "
        f"trace: {res}")
    return {"name": "cifg_cell_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/cifg_cell/csrc/cifg_cell_bwd.cu",
            "replaces": "src/repro/kernels/cifg_cell/cifg_cell.py:122",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


# the client axis: phase 5's chunk of clients and phase 9's (152 selected
# clients pad to 152, blocks of 19)
CLIENT_CHUNKS = (16, 19)


def _client_cell_inputs(C, S, B, H, gen, dev, bwd=False):
    """A chunk of C clients' inputs of the sequence forward (zx, h0, c0,
    w_h) or of the sequence backward (its seven), each client its own."""
    if bwd:
        per = [_bwd_seq_inputs(S, B, H, gen, dev) for _ in range(C)]
    else:
        per = [_cell_inputs(B, H, gen, dev, S=S) for _ in range(C)]
    import torch

    return [torch.stack(a) for a in zip(*per)]


def phase_kernel_clients(dev) -> dict:
    """The client axis of both cell kernels (a cohort chunk in one launch,
    each client with its own w_h) at the training shape S 16, B 10 for the
    chunks of phases 5 and 9 (C 16, 19): H 256 and the wide route (264
    resident, 520 streamed), the forward in bf16 and f32, against the plain
    versions with the same axis and each client bitwise its one-client
    launch; the forward with one shared w_h (stride 0) bitwise too; how many
    clusters the card holds at once (a chunk past that runs in waves);
    device times from CUDA-graph replays against the bound, the plain
    versions, the PyTorch loops and C one-client launches. Returns the
    timed C = 16 rows of both kernels."""
    import torch

    from repro_torch.kernels.cifg_cell import ops
    from repro_torch.kernels.cifg_cell.ops import (cell_bwd_seq,
                                                   cell_bwd_seq_ref,
                                                   cell_seq_fwd, cifg_states)

    S, B, tiles = 16, 10, 1
    for name, dtypes in (("cifg_cell_fwd", (torch.bfloat16, torch.float32)),
                         ("cifg_cell_bwd_seq", (torch.float32,))):
        for H in (256, 264, 520):
            for dt in dtypes:
                most = ops.max_active_clusters(name, B, H, dt)
                say(f"kernel: {name} {str(dt).split('.')[-1]} B={B} H={H}: "
                    f"{most} clusters at once (cudaOccupancyMaxActiveClusters"
                    f"); " + ", ".join(
                        f"C={C}: {C * tiles} clusters, "
                        f"{-(-C * tiles // most)} wave(s)"
                        for C in CLIENT_CHUNKS))
    gen = torch.Generator().manual_seed(4321)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for cd in (torch.bfloat16, torch.float32):
        name = str(cd).split(".")[-1]
        atol, rtol = TOL[name]
        for H in (256, 264, 520):
            for C in CLIENT_CHUNKS:
                zx, h0, c0, w = _client_cell_inputs(C, S, B, H, gen, dev)
                w = w.to(cd)
                hs, cs = cell_seq_fwd(zx, h0, c0, w)
                hr, cr = cifg_states(zx, h0, c0, w, cell="seq")
                torch.cuda.synchronize()
                for what, a, b in (("h", hs, hr), ("c", cs, cr)):
                    err = (a - b).abs()
                    if not bool((err <= atol + rtol * b.abs()).all()):
                        fail(f"cifg_cell_fwd with a client axis disagrees "
                             f"with plain ({name} C={C} H={H}): max abs err "
                             f"{float((a - b).abs().max()):.3e}")
                    worst["fwd"] = max(worst["fwd"],
                                       float((a - b).abs().max()))
                for c in range(C):
                    h1, c1 = cell_seq_fwd(zx[c], h0[c], c0[c], w[c])
                    if not (torch.equal(hs[c], h1) and torch.equal(cs[c], c1)):
                        fail(f"cifg_cell_fwd client {c} of {C} differs from "
                             f"its one-client launch ({name} H={H})")
                hsh, csh = cell_seq_fwd(zx, h0, c0, w[0])
                for c in (0, C - 1):
                    h1, c1 = cell_seq_fwd(zx[c], h0[c], c0[c], w[0])
                    if not (torch.equal(hsh[c], h1)
                            and torch.equal(csh[c], c1)):
                        fail(f"cifg_cell_fwd with a shared w_h: client {c} "
                             f"of {C} differs ({name} H={H})")
            say(f"kernel: cifg_cell_fwd {name} with a client axis, S={S} "
                f"B={B} H={H}, C {CLIENT_CHUNKS}: within tol of the plain "
                f"recurrence (worst so far {worst['fwd']:.3e}); every client "
                f"bitwise its one-client launch; a shared w_h bitwise too")
    atol, rtol = TOL_BWD_SEQ
    for H in (256, 264, 520):
        for C in CLIENT_CHUNKS:
            args = _client_cell_inputs(C, S, B, H, gen, dev, bwd=True)
            got = cell_bwd_seq(*args)
            want = cell_bwd_seq_ref(*args)
            torch.cuda.synchronize()
            for what, a, b in zip(("dz", "dh0", "dc0"), got, want):
                if not bool(((a - b).abs() <= atol + rtol * b.abs()).all()):
                    fail(f"cifg_cell_bwd_seq with a client axis disagrees "
                         f"with plain ({what}, C={C} H={H}): max abs err "
                         f"{float((a - b).abs().max()):.3e}")
                worst["bwd"] = max(worst["bwd"], float((a - b).abs().max()))
            for c in range(C):
                one = cell_bwd_seq(*[a[c] for a in args])
                if not all(torch.equal(a[c], b) for a, b in zip(got, one)):
                    fail(f"cifg_cell_bwd_seq client {c} of {C} differs from "
                         f"its one-client launch (H={H})")
        say(f"kernel: cifg_cell_bwd_seq with a client axis, S={S} B={B} "
            f"H={H}, C {CLIENT_CHUNKS}: within tol of the plain loop (worst "
            f"so far {worst['bwd']:.3e}); every client bitwise its "
            f"one-client launch")

    # device times: the chunk in one launch against C one-client launches,
    # the plain versions with the client axis and the PyTorch loops
    rows = {}
    timed = [("fwd", torch.bfloat16, 256, C) for C in CLIENT_CHUNKS]
    timed += [("fwd", torch.float32, 256, 16), ("fwd", torch.bfloat16, 264,
                                                 16),
              ("fwd", torch.bfloat16, 520, 16)]
    timed += [("bwd", torch.float32, 256, C) for C in CLIENT_CHUNKS]
    timed += [("bwd", torch.float32, 264, 16), ("bwd", torch.float32, 520,
                                                 16)]
    for kind, cd, H, C in timed:
        main = H == 256 and cd == (torch.bfloat16 if kind == "fwd"
                                   else torch.float32)
        if kind == "fwd":
            zx, h0, c0, w = _client_cell_inputs(C, S, B, H, gen, dev)
            w = w.to(cd)
            hs, cs = torch.empty((2, C, S, B, H), device=dev)
            one = (zx[0].contiguous(), h0[0].contiguous(), c0[0].contiguous(),
                   w[0].contiguous())
            ms = graph_time_ms(lambda: cell_seq_fwd(zx, h0, c0, w, hs=hs,
                                                    cs=cs))
            ms1 = graph_time_ms(lambda: cell_seq_fwd(*one))
            nbytes = C * ((S * B * 3 * H + 2 * B * H + 2 * S * B * H) * 4
                          + 3 * H * H * w.element_size())
            bound_ms, bound_by = _bound(nbytes, C * 2 * S * B * H * 3 * H,
                                        str(cd).split(".")[-1])
            if main:
                plain_ms = graph_time_ms(
                    lambda: cifg_states(zx, h0, c0, w, cell="seq"),
                    per_graph=2)
                library_ms = graph_time_ms(_addmm_loop(zx, h0, c0, w),
                                           per_graph=2)
        else:
            args = _client_cell_inputs(C, S, B, H, gen, dev, bwd=True)
            one = [a[0].contiguous() for a in args]
            ms = graph_time_ms(lambda: cell_bwd_seq(*args))
            ms1 = graph_time_ms(lambda: cell_bwd_seq(*one))
            b1, bound_by, _, _ = _bwd_seq_bound(S, B, H)
            bound_ms = C * b1
            if main:
                plain_ms = graph_time_ms(lambda: cell_bwd_seq_ref(*args),
                                         per_graph=2)
                library_ms = graph_time_ms(_reverse_loop(*args),
                                           per_graph=2)
        kname = "cifg_cell_fwd" if kind == "fwd" else "cifg_cell_bwd_seq"
        most = ops.max_active_clusters(kname, B, H, cd)
        line = (f"kernel: {kname} {str(cd).split('.')[-1]} a chunk of C={C} "
                f"clients S={S} B={B} H={H} in one launch ({C} clusters, "
                f"{most} at once: {-(-C // most)} wave(s)), device time "
                f"{ms * 1e3:.2f} us/launch against one client's launch "
                f"{ms1 * 1e3:.2f} us (x{C} = {C * ms1 * 1e3:.2f} us); bound "
                f"{bound_ms * 1e3:.3f} us ({bound_by})")
        if main:
            lib = "baddbmm" if kind == "fwd" else "bmm"
            line += (f"; plain with the client axis {plain_ms * 1e3:.2f} us; "
                     f"the PyTorch loop ({lib} a step) "
                     f"{library_ms * 1e3:.2f} us")
            if C == 16:
                rows[kind] = {"ms": ms, "plain_ms": plain_ms,
                              "library_ms": library_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by,
                              "max_abs_err": worst[kind]}
        say(line)
    return rows


CLIP_SIZES = (1, 127, 32769, 983040, 196608)
CLIP_CHUNKS = (1, 2, 16, 32)


def phase_kernel_clip(dev) -> list:
    """dp_sumsq and dp_clip_accumulate vs their plain versions at ragged
    lengths and at the model's leaf sizes: sumsq within float tolerance and
    bitwise repeatable; the accumulate of C ∈ CLIP_CHUNKS clients in one
    launch bitwise equal to plain and to C one-client launches, a zero
    factor over 1e30 garbage leaves acc bitwise unchanged, and ``out`` may
    be ``acc``. Timed at the largest leaf (the 10240 x 96 embedding): the
    accumulate at C = 1 against ``torch.add`` and at phase 5's chunk of 16
    against 16 chained ``torch.add`` calls."""
    import torch

    from repro_torch.kernels.dp_clip import (clip_accumulate_chunk_leaf,
                                             clip_accumulate_leaf, sumsq)
    from repro_torch.kernels.dp_clip.ref import (clip_accumulate_chunk_ref,
                                                 sumsq_ref)

    gen = torch.Generator().manual_seed(77)
    worst_ss = 0.0
    for n in CLIP_SIZES:
        x = torch.randn((n,), generator=gen).to(dev)
        s1, s2 = sumsq(x), sumsq(x)
        ref = sumsq_ref(x)
        torch.cuda.synchronize()
        if not torch.equal(s1, s2):
            fail(f"dp_sumsq not repeatable at n={n}")
        rel = float((s1 - ref).abs() / ref.abs().clamp(min=1e-30))
        if rel > 1e-5:
            fail(f"dp_sumsq disagrees with plain at n={n}: rel err {rel:.2e}")
        worst_ss = max(worst_ss, float((s1 - ref).abs()))
        garbage = torch.full((n,), 1e30, device=dev)
        garbage[::2] = -1e30
        for C in CLIP_CHUNKS:
            acc = torch.randn((n,), generator=gen).to(dev)
            deltas = [torch.randn((n,), generator=gen).to(dev)
                      for _ in range(C)]
            factors = torch.stack([torch.clamp(0.8 / torch.sqrt(sumsq(d)),
                                               max=1.0) for d in deltas])
            factors[C // 2] = 0.0          # a masked slot
            out = clip_accumulate_chunk_leaf(acc, deltas, factors)
            if not torch.equal(out, clip_accumulate_chunk_ref(acc, deltas,
                                                              factors)):
                fail(f"dp_clip_accumulate differs from plain at n={n} C={C}")
            seq = acc
            for c in range(C):
                seq = clip_accumulate_leaf(seq, deltas[c], factors[c])
            if not torch.equal(out, seq):
                fail(f"dp_clip_accumulate at n={n} C={C} differs from {C} "
                     f"one-client launches")
            masked = list(deltas)
            masked[C // 2] = garbage
            if not torch.equal(clip_accumulate_chunk_leaf(acc, masked,
                                                          factors), out):
                fail(f"dp_clip_accumulate: factor 0 over 1e30 moved the sum, "
                     f"n={n} C={C}")
            zero = torch.zeros((C,), device=dev)
            if not torch.equal(clip_accumulate_chunk_leaf(
                    acc, [garbage] * C, zero), acc):
                fail(f"dp_clip_accumulate: factor 0 over 1e30 changed acc, "
                     f"n={n} C={C}")
            clip_accumulate_chunk_leaf(acc, deltas, factors, out=acc)
            if not torch.equal(acc, out):
                fail(f"dp_clip_accumulate with out = acc differs, n={n} C={C}")
        say(f"kernel: dp_sumsq n={n}: rel err {rel:.2e} (tol 1e-5), bitwise "
            f"repeatable; dp_clip_accumulate at C in {CLIP_CHUNKS}: bitwise "
            f"equal to plain and to C one-client launches, zero factor over "
            f"1e30 adds +-0, out = acc gives the same bits")

    n = 983040
    x = torch.randn((n,), generator=gen).to(dev)
    rows = []
    ms = graph_time_ms(lambda: sumsq(x))
    plain_ms = graph_time_ms(lambda: sumsq_ref(x))
    library_ms = graph_time_ms(lambda: torch.dot(x, x))
    eager_ms = cuda_time_ms(lambda: sumsq(x), 1000)
    nbytes = 4 * n + 4
    bound_ms, bound_by = _bound(nbytes, 2 * n, "float32")
    say(f"kernel: dp_sumsq one leaf n={n} f32, device time: "
        f"{ms * 1e3:.2f} us/launch; plain {plain_ms * 1e3:.2f} us; "
        f"torch.dot {library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
        f"({nbytes / 1e6:.2f} MB); one eager call {eager_ms * 1e3:.2f} us")
    rows.append(phase_sumsq_chunk(dev, gen, worst_ss))

    # the accumulate: C = 1 (warm L2: acc, delta and out are 11.8 MB) and
    # phase 5's chunk of C = 16 (63 MB of deltas, more than the 50 MB L2,
    # so cold as in a round); the row of the kernels line is C = 16
    acc = torch.randn((n,), generator=gen).to(dev)
    for C in (1, 16):
        deltas = [torch.randn((n,), generator=gen).to(dev) for _ in range(C)]
        factors = torch.rand((C,), generator=gen).to(dev)
        alphas = factors.tolist()

        def library():
            out = torch.add(acc, deltas[0], alpha=alphas[0])
            for c in range(1, C):
                out = torch.add(out, deltas[c], alpha=alphas[c])
            return out

        ms = graph_time_ms(lambda: clip_accumulate_chunk_leaf(acc, deltas,
                                                              factors))
        plain_ms = graph_time_ms(lambda: clip_accumulate_chunk_ref(
            acc, deltas, factors))
        library_ms = graph_time_ms(library)
        eager_ms = cuda_time_ms(lambda: clip_accumulate_chunk_leaf(
            acc, deltas, factors), 1000)
        nbytes = (8 + 4 * C) * n + 4 * C
        bound_ms, bound_by = _bound(nbytes, 2 * C * n, "float32")
        say(f"kernel: dp_clip_accumulate n={n} C={C} f32, device time: "
            f"{ms * 1e3:.2f} us/launch ({ms * 1e3 / C:.2f} us per client); "
            f"plain {plain_ms * 1e3:.2f} us; {C} chained torch.add(alpha) "
            f"{library_ms * 1e3:.2f} us; bound {bound_ms * 1e3:.3f} us "
            f"({nbytes / 1e6:.2f} MB{', warm L2' if C == 1 else ''}); one "
            f"eager call {eager_ms * 1e3:.2f} us")
    rows.append({"name": "dp_clip_accumulate", "route": "cuda",
                 "source": "src/repro_torch/kernels/dp_clip/csrc/dp_clip.cu",
                 "replaces": "src/repro/kernels/dp_clip/dp_clip.py:87",
                 "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": bound_ms, "bound_by": bound_by,
                 "library_ms": library_ms})
    return rows


# the leaves of gboard-cifg-lstm's update (embedding, w_x, w_h, b_gates,
# w_proj), 1,278,720 f32
CLIP_LEAVES = (983040, 73728, 196608, 768, 24576)


def phase_sumsq_chunk(dev, gen, worst_ss: float) -> dict:
    """sumsq_chunk (a chunk of clients, every leaf, one launch) at the
    model's leaf sizes: each slot's ss, norm and factor bitwise those of
    fused_sumsq (one launch per leaf) + clip_factor · mask, a masked slot's
    factor 0, close to the plain float32 sums; bitwise the same in every
    chunk width 1-16 and slot position; timed at C 1 and 16 against its
    bound, the plain version and torch._foreach_norm over the same leaves.
    Returns the dp_sumsq row (the chunk form at C 16)."""
    import torch

    from repro_torch.core.clipping import clip_factor
    from repro_torch.kernels.dp_clip import fused_sumsq, sumsq_chunk
    from repro_torch.kernels.dp_clip.ops import LAUNCHES, MAX_LEAVES
    from repro_torch.kernels.dp_clip.ref import sumsq_chunk_ref

    def trees(C, scale=1e-3):
        return [{"abcde"[i]: (torch.randn((n,), generator=gen) * scale).to(dev)
                 for i, n in enumerate(CLIP_LEAVES)} for _ in range(C)]

    chunk = trees(16)
    chunk[3] = {k: x * 1e3 for k, x in chunk[3].items()}   # a clipped slot
    mask = [torch.tensor(float(c != 5), device=dev) for c in range(16)]
    ss, norms, factors = sumsq_chunk(chunk, 0.8, mask)
    p_ss, _, _ = sumsq_chunk_ref(
        [[t[k].cpu() for k in sorted(t)] for t in chunk], 0.8)
    torch.cuda.synchronize()
    worst = worst_ss
    for c, tree in enumerate(chunk):
        s1 = fused_sumsq(tree)
        n1 = torch.sqrt(s1)
        if not (torch.equal(ss[c], s1) and torch.equal(norms[c], n1)
                and torch.equal(factors[c], clip_factor(n1, 0.8) * mask[c])):
            fail(f"sumsq_chunk slot {c} differs from fused_sumsq + "
                 f"clip_factor")
        rel = abs(float(ss[c]) - float(p_ss[c])) / float(p_ss[c])
        if not rel <= TOL_SUMSQ:
            fail(f"sumsq_chunk slot {c} disagrees with plain: rel {rel:.2e}")
        worst = max(worst, abs(float(ss[c]) - float(p_ss[c])))
    if float(factors[5]) != 0.0 or not float(factors[3]) < 1.0:
        fail(f"sumsq_chunk factors {factors.tolist()}: the masked slot 5 "
             f"must be 0 and slot 3 clipped")
    for C in range(1, 17):
        for c0 in sorted({0, (16 - C) // 2, 16 - C}):
            got = sumsq_chunk(chunk[c0:c0 + C], 0.8, mask[c0:c0 + C])
            if not all(torch.equal(a, b[c0:c0 + C])
                       for a, b in zip(got, (ss, norms, factors))):
                fail(f"sumsq_chunk differs in a chunk of {C} at {c0}")
    say(f"kernel: dp_sumsq chunk of 16 x {len(CLIP_LEAVES)} leaves "
        f"{CLIP_LEAVES}: ss, norm and factor bitwise fused_sumsq + "
        f"clip_factor x mask in every slot, masked slot factor 0, within "
        f"rtol {TOL_SUMSQ:g} of the plain sums; bitwise the same in chunks "
        f"of 1-16 at every tested position")
    # a tree of more leaves than one launch takes: the sums carried across
    # launches of MAX_LEAVES leaves give the same bits
    many = [{f"l{i:02d}": (torch.randn((97 * i + 5,), generator=gen)
                           * 0.05).to(dev) for i in range(MAX_LEAVES + 5)}
            for _ in range(16)]
    before = LAUNCHES["dp_sumsq"]
    got = sumsq_chunk(many, 0.8, mask)
    n_launch = LAUNCHES["dp_sumsq"] - before
    torch.cuda.synchronize()
    for c, tree in enumerate(many):
        s1 = fused_sumsq(tree)
        n1 = torch.sqrt(s1)
        if not (torch.equal(got[0][c], s1) and torch.equal(got[1][c], n1)
                and torch.equal(got[2][c],
                                clip_factor(n1, 0.8) * mask[c])):
            fail(f"sumsq_chunk over {MAX_LEAVES + 5} leaves: slot {c} "
                 f"differs from fused_sumsq + clip_factor")
    say(f"kernel: dp_sumsq chunk of 16 x {MAX_LEAVES + 5} leaves in "
        f"{n_launch} launches: "
        f"every slot bitwise fused_sumsq + clip_factor x mask")

    row = None
    for C in (1, 16):
        leaves = trees(C)
        flat = [x for t in leaves for x in t.values()]
        scales = [torch.ones((), device=dev)] * C
        ms = graph_time_ms(lambda: sumsq_chunk(leaves, 0.8, scales),
                           per_graph=20)
        plain_ms = graph_time_ms(
            lambda: sumsq_chunk_ref([list(t.values()) for t in leaves], 0.8,
                                    torch.stack(scales)), per_graph=5)
        library_ms = graph_time_ms(lambda: torch._foreach_norm(flat),
                                   per_graph=20)
        eager_ms = cuda_time_ms(lambda: sumsq_chunk(leaves, 0.8, scales), 200)
        n_all = C * sum(CLIP_LEAVES)
        nbytes = 4 * n_all + 3 * 4 * C
        bound_ms, bound_by = _bound(nbytes, 2 * n_all, "float32")
        say(f"kernel: dp_sumsq chunk C={C} x {sum(CLIP_LEAVES)} f32 "
            f"({len(CLIP_LEAVES)} leaves each), device time: "
            f"{ms * 1e3:.2f} us/launch ({ms * 1e3 / C:.2f} us a client); "
            f"plain {plain_ms * 1e3:.2f} us; torch._foreach_norm over the "
            f"{C * len(CLIP_LEAVES)} leaves {library_ms * 1e3:.2f} us; bound "
            f"{bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, {bound_by}); "
            f"one eager call {eager_ms * 1e3:.2f} us")
        row = {"name": "dp_sumsq", "route": "cuda",
               "source": "src/repro_torch/kernels/dp_clip/csrc/dp_clip.cu",
               "replaces": "src/repro/kernels/dp_clip/dp_clip.py:66",
               "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
    return row


def profiled_device_ms(fn, iters: int, warmup: bool = True, top: int = 6,
                       cpu: bool = True):
    """Device (kernel) time per ``fn()`` call over ``iters`` calls, from
    ``torch.profiler``'s CUDA activity, the host wall time per call of the
    profiled window, and the ``top`` kernels (all for ``None``) with the
    most device time as (name, ms per call, launches per call); device time
    is None when the profiler saw no kernel. Only the kernel events are
    summed: an operator's own device time is its kernels' time counted a
    second time. ``cpu=False`` records the device activity alone, which
    makes the trace of a long call far quicker to process."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
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


def kernel_resources(fn, name: str) -> str:
    """The registers per thread, shared memory per block and resident
    blocks per SM of the kernel whose name holds ``name``, as the profiler's
    trace reports them for ``fn()`` calls, as text; the blocks follow from
    the first two and the H100's 64K registers and 228 KB of shared memory
    per SM (the trace's own occupancy estimate is not filled in on this
    card). The profiler now and then delivers a trace without the calls'
    kernels: up to five traces of three calls each are taken, and if none
    holds the kernel its resources are "not measured" (they are
    informational; no check reads them)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        for e in events:
            args = e.get("args", {})
            if e.get("cat") == "kernel" and name in e.get("name", ""):
                regs = int(args["registers per thread"])
                smem = int(args["shared memory"])
                threads = 1
                for d in args["block"]:
                    threads *= int(d)
                # registers: allocated per warp in units of 256; shared
                # memory: 1 KB reserved per block
                per_warp = -(-regs * 32 // 256) * 256
                by_regs = 65536 // (per_warp * -(-threads // 32))
                by_smem = 233472 // (smem + 1024)
                blocks = min(by_regs, by_smem, 2048 // threads, 32)
                return (f"{regs} registers per thread, {smem} bytes of "
                        f"shared memory per block of {threads} threads: "
                        f"{blocks} resident blocks ({blocks * threads // 32} "
                        f"of 64 warps) per SM")
    return "not measured (five profiler traces held no such kernel)"


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
    from repro_torch.core.clipping import (clip_accumulate_chunk_tree,
                                           clip_accumulate_tree, clip_factor)
    from repro_torch.core.dp_fedavg import finalize_round
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fl.client import (local_delta, local_deltas, local_sgd,
                                       round_compute)
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.reduction import resolve_chunk
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
    # one sum-of-squares launch and one accumulate launch per leaf per live
    # chunk (every chunk of a full round of a multiple of 8 clients is live)
    chunk = resolve_chunk(None, cohort // 8)
    chunks = clients // chunk
    # one forward and one backward cell launch per chunk and local batch
    # (the chunk's clients and the whole sequence in one launch); the
    # per-step backward is not on this path
    want = {"cifg_cell_fwd": n_batches * chunks,
            "cifg_cell_bwd_seq": n_batches * chunks, "cifg_cell_bwd": 0,
            "dp_sumsq": chunks, "dp_clip_accumulate": 5 * chunks}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"training launched {k} {launches[k]} times, expected {v} "
                 f"({clients} clients in {chunks} chunks over {rounds} rounds)")
    say(f"train: gboard-cifg-lstm vocab {cfg.vocab} (padded "
        f"{-(-cfg.vocab // 256) * 256}) d {cfg.d_model} H {cfg.d_ff} "
        f"{cfg.compute_dtype}, {n_params} parameters; {n_users} users "
        f"(made in {data_s:.1f} s), cohort {cohort}, {n_batches} batches of "
        f"{batch} x {seq_len} per client: {rounds} rounds in {run_s:.2f} s = "
        f"{rounds / run_s:.3f} rounds/s; losses "
        f"{[round(r['loss'], 4) for r in recs]}; norms "
        f"{[round(r['mean_update_norm'], 4) for r in recs]}; clipped "
        f"{[r['frac_clipped'] for r in recs]}; launches {launches} "
        f"({clients} clients in {chunks} chunks of {chunk}); peak "
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

    # before and after this slice's kernels, in turns in this run: a client
    # step with the reverse recursion as the plain loop (16 f32 torch.mm and
    # their elementwise ops, as training ran it before) against one
    # cifg_cell_bwd_seq launch; a chunk's clip with one fused_sumsq per
    # client and leaf against one sumsq_chunk launch
    def plain_recursion(fn):
        kernel = cell_ops.cell_bwd_seq
        cell_ops.cell_bwd_seq = cell_ops.cell_bwd_seq_ref
        try:
            return fn()
        finally:
            cell_ops.cell_bwd_seq = kernel

    deltas = [tree_map(lambda l: torch.randn_like(l) * 1e-3, params)
              for _ in range(16)]
    masks = [torch.ones((), device=dev)] * 16

    def chunk_after():
        return clip_accumulate_chunk_tree(acc, deltas, dp.clip_norm, masks)

    def chunk_before():
        factors, norms = [], []
        for d, m in zip(deltas, masks):
            ss = clip_ops.fused_sumsq(d)
            factors.append(clip_factor(torch.sqrt(ss), dp.clip_norm) * m)
            norms.append(torch.sqrt(ss))
        f = torch.stack(factors)
        new = tree_map(lambda a, *ds: clip_ops.clip_accumulate_chunk_leaf(
            a, ds, f), acc, *deltas)
        return new, norms, [(clip_factor(n, dp.clip_norm) < 1.0).float()
                            for n in norms]

    for a, b in zip(tree_leaves(chunk_after()[0]),
                    tree_leaves(chunk_before()[0])):
        if not torch.equal(a, b):
            fail("the chunk's clip differs from one fused_sumsq per client")
    turns = {"step": [], "step_plain": [], "chunk": [], "chunk_plain": []}
    for order in (0, 1):
        for plain in ((False, True) if order == 0 else (True, False)):
            run = (lambda f: plain_recursion(f)) if plain else (lambda f: f())
            key = "_plain" if plain else ""
            eager = run(lambda: cuda_time_ms(step, 10, warmup=2))
            dev_ms, _, _ = run(lambda: profiled_device_ms(step, 5))
            turns["step" + key].append((eager, dev_ms))
            fn = chunk_before if plain else chunk_after
            turns["chunk" + key].append((cuda_time_ms(fn, 20, warmup=2),
                                         profiled_device_ms(fn, 5)[0]))

    def mean(key, i):
        vals = [v[i] for v in turns[key]]
        return None if None in vals else sum(vals) / len(vals)

    def busy_share(dev_ms, eager_ms):
        return ("not measured" if dev_ms is None
                else f"{100 * dev_ms / eager_ms:.1f}%")

    for what, unit, before in (
            ("step", "client SGD step (batch 10 x 16)",
             "the plain reverse loop"),
            ("chunk", "clip + accumulate of a chunk of 16",
             "one fused_sumsq per client")):
        e1, d1 = mean(what, 0), mean(what, 1)
        e0, d0 = mean(what + "_plain", 0), mean(what + "_plain", 1)
        say(f"train: one {unit}, this slice's kernels against the path "
            f"before them ({before}), mean of 2 turns each: eager "
            f"{e1:.3f} ms vs {e0:.3f} ms; on the device {_fmt_ms(d1)} vs "
            f"{_fmt_ms(d0)}; device busy {busy_share(d1, e1)} vs "
            f"{busy_share(d0, e0)} of "
            f"the eager time")
    # one chunk of the round's width (16 at cohort 128) three ways, in
    # turns in this run: the clients one after another through loss_fn (the
    # port before the chunk was batched), a local_delta call a client (the
    # chunk program at a width of 1) and one local_deltas
    one_chunk = tree_map(lambda l: l[:chunk], stacked)
    loop_model = model._replace(client_loss_fn=None)
    ways = {
        "the clients one after another through loss_fn": lambda: local_deltas(
            loop_model, params, one_chunk, cl),
        f"{chunk} calls of local_delta": lambda: [
            local_delta(model, params, tree_map(lambda l: l[c], one_chunk), cl)
            for c in range(chunk)],
        "one local_deltas": lambda: local_deltas(model, params, one_chunk, cl)}
    one_by_one = ways[f"{chunk} calls of local_delta"]()
    together = ways["one local_deltas"]()
    for c, (d, loss) in enumerate(one_by_one):
        if not (torch.equal(loss, together[1][c]) and all(
                torch.equal(a, b) for a, b in zip(tree_leaves(d),
                                                  tree_leaves(together[0][c])
                                                  ))):
            fail(f"train: client {c}'s delta or loss differs between "
                 f"local_delta and the chunk's local_deltas")
    timed = {k: [] for k in ways}
    for order in (list(ways), list(ways)[::-1]):
        for k in order:
            timed[k].append((cuda_time_ms(ways[k], 2, warmup=1),
                             profiled_device_ms(ways[k], 1, top=8)))
    chunk_ms = {}
    for k, runs in timed.items():
        eager = sum(e for e, _ in runs) / len(runs)
        devs = [d[0] for _, d in runs]
        dev_ms = None if None in devs else sum(devs) / len(devs)
        chunk_ms[k] = (eager, dev_ms)
        say(f"train: a chunk of {chunk} clients ({n_batches} batches of "
            f"{batch} x {seq_len} each), {k}: {eager:.2f} ms eager, "
            f"{_fmt_ms(dev_ms)} on the device (busy "
            f"{busy_share(dev_ms, eager)}), mean of 2 turns; "
            f"device time by kernel: " + "; ".join(
                f"{name} {ms * 1e3:.1f} us x{n:g}"
                for name, ms, n in runs[-1][1][2]))
    say(f"train: every client's delta and loss bitwise equal between "
        f"{chunk} calls of local_delta and one local_deltas of the chunk")

    # rounds/s before and after in this run: rounds of the same trainer's
    # model with the chunk's clients one after another, then batched
    loop_trainer = FederatedTrainer(loop_model, ds, dp, cl, pop=pop, seed=1,
                                    n_local_batches=n_batches, device=dev)
    turns_rps = {"one after another": [], "batched": []}
    for which, tr in (("one after another", loop_trainer),
                      ("batched", trainer), ("batched", trainer),
                      ("one after another", loop_trainer)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run_round()
        torch.cuda.synchronize()
        turns_rps[which].append(time.perf_counter() - t0)
    say(f"train: rounds/s at cohort {cohort}, in turns in this run: the "
        f"chunk's clients one after another " + ", ".join(
            f"{1 / t:.3f}" for t in turns_rps["one after another"])
        + "; batched " + ", ".join(
            f"{1 / t:.3f}" for t in turns_rps["batched"]))

    round_dev, round_wall, _ = profiled_device_ms(trainer.run_round, 1,
                                                  warmup=False)
    busy = None if round_dev is None else 100 * round_dev / round_wall
    round_ms = run_s / rounds * 1e3
    chunk_step = chunk_ms["one local_deltas"][0] / n_batches
    chunk_clip = mean("chunk", 0)
    n_chunks = cohort // chunk
    say(f"train: one client SGD step (batch {batch} x {seq_len}, the chunk "
        f"program at a width of 1) "
        f"{step_eager:.3f} ms eager, {_fmt_ms(step_dev)} on the device "
        f"(busy {busy_share(step_dev, step_eager)}); "
        f"clip + accumulate of one client {clip_eager:.3f} ms eager, "
        f"{_fmt_ms(clip_dev)} on the device; a round {round_ms:.1f} ms "
        f"= {n_chunks * n_batches} chunk steps of {chunk} clients x "
        f"{chunk_step:.3f} ms + {n_chunks} chunk clips x {chunk_clip:.3f} ms "
        f"+ {round_ms - n_chunks * (n_batches * chunk_step + chunk_clip):.1f}"
        f" ms else; device busy "
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
    # the decoders' prefills: granite-3-2b (GQA 32/8, hd 64), olmoe-1b-7b
    # (MHA 16, hd 128), phi3-mini-3.8b (hd 96), phi3-medium-14b (GQA
    # 40/10, hd 128)
    (4, 512, 32, 8, 64, True, 0, "bfloat16"),
    (4, 512, 16, 16, 128, True, 0, "bfloat16"),
    (2, 512, 32, 32, 96, True, 0, "bfloat16"),
    (2, 512, 40, 10, 128, True, 0, "bfloat16"),
    # hd > 128 (bf16 on the wide route, f32 over more than one output
    # slice): stablelm-12b's 160, then 192 and 256
    (4, 512, 32, 32, 160, True, 0, "bfloat16"),
    (2, 512, 32, 8, 160, True, 128, "bfloat16"),
    (2, 300, 16, 16, 160, False, 0, "bfloat16"),
    (2, 512, 16, 16, 192, True, 0, "bfloat16"),
    (2, 256, 16, 4, 256, False, 64, "bfloat16"),
    (1, 200, 8, 8, 160, True, 0, "float32"),
    (1, 130, 4, 2, 256, False, 0, "float32"),
)
# the wide route's timed shape: stablelm-12b's head dim at the prefill's
# (B 4, S 512, 32 heads, causal, bf16)
FLASH_WIDE_TIMED = (4, 512, 32, 32, 160)
# the decoders' main-path shapes (B, S, H, KV, hd), causal, bf16:
# granite-3-2b's and olmoe-1b-7b's prefill of 4 x 512
FLASH_DECODER_TIMED = ((4, 512, 32, 8, 64), (4, 512, 16, 16, 128))
# whisper-small's two bidirectional shapes (B, Sq, Sk, H, hd), held in
# both dtypes and timed in bf16: the encoder over 1,500 frames (1,500 =
# 23 x 64 + 28: the last K tile is partial) and the cross-attention of a
# 64-token prompt against them
FLASH_WHISPER = (("encoder", 4, 1500, 1500, 12, 64),
                 ("cross-attention", 4, 64, 1500, 12, 64))


def phase_kernel_flash(dev) -> dict:
    """flash_attention_fwd vs its plain version at the hybrid prefill's
    shape (B 4, S 512, 32 heads, hd 80, causal, bf16) and around it (hd 64
    and 128, GQA, ragged S, window, bidirectional, f32), at the decoders'
    prefill shapes (GQA 32/8 at hd 64, hd 96, hd 128 MHA and GQA 40/10), and
    on the wide route (hd 160, 192, 256); every bf16 case on the tensor
    cores; timed at the hybrid's shape, at hd 160 and at granite-3-2b's and
    olmoe-1b-7b's prefill shapes against the bound, the plain version and
    SDPA."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention,
                                                     flash_attention_ref)

    gen = torch.Generator().manual_seed(5150)
    worst = 0.0
    for B, S, H, KV, hd, causal, window, dname in FLASH_CASES:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(shape, generator=gen).to(dev, dtype)
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        tc_before = LAUNCHES["flash_attention_fwd_tc"]
        out = flash_attention(q, k, v, causal=causal, window=window)
        if LAUNCHES["flash_attention_fwd_tc"] - tc_before != (
                dname == "bfloat16"):
            fail(f"flash_attention_fwd {dname}: the tensor-core form ran "
                 f"{LAUNCHES['flash_attention_fwd_tc'] - tc_before} times")
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
            f"(tol atol = rtol = {tol:g}); "
            f"{'tensor cores' if dname == 'bfloat16' else 'CUDA cores'}")

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
    res = kernel_resources(lambda: flash_attention(q, k, v),
                           "flash_fwd_tc_kernel")
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
    say(f"kernel: flash_attention_fwd bf16 (tensor cores), from the "
        f"profiler's trace: {res}")

    B, S, H, KV, hd = FLASH_WIDE_TIMED
    q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    wide_ms = graph_time_ms(lambda: flash_attention(q, k, v), per_graph=20)
    wide_plain = graph_time_ms(lambda: flash_attention_ref(q, k, v),
                               per_graph=5)
    wide_sdpa = graph_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), per_graph=20)
    wide_res = kernel_resources(lambda: flash_attention(q, k, v),
                                "flash_fwd_tc_wide_kernel")
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
    ops = 4 * B * H * hd * _attention_pairs(S, S, True, 0)
    wb_ms, wb_by = _bound(nbytes, ops, "bfloat16")
    say(f"kernel: flash_attention_fwd wide route bf16 B={B} S={S} H={H} "
        f"hd={hd} causal, device time: {wide_ms * 1e3:.2f} us/launch; plain "
        f"{wide_plain * 1e3:.2f} us; F.scaled_dot_product_attention "
        f"{wide_sdpa * 1e3:.2f} us; bound {wb_ms * 1e3:.3f} us "
        f"({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP, {wb_by}); from the "
        f"profiler's trace: {wide_res}")
    for B, S, H, KV, hd in FLASH_DECODER_TIMED:
        q, k, v = (torch.randn(shape, generator=gen).to(dev, torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KV, hd),
                                 (B, S, KV, hd)))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        d_ms = graph_time_ms(lambda: flash_attention(q, k, v), per_graph=20)
        d_plain = graph_time_ms(lambda: flash_attention_ref(q, k, v),
                                per_graph=5)
        d_sdpa = graph_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=KV < H), per_graph=20)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        ops = 4 * B * H * hd * _attention_pairs(S, S, True, 0)
        db_ms, db_by = _bound(nbytes, ops, "bfloat16")
        say(f"kernel: flash_attention_fwd bf16 B={B} S={S} H={H} KV={KV} "
            f"hd={hd} causal (a decoder prefill's), device time: "
            f"{d_ms * 1e3:.2f} us/launch; plain {d_plain * 1e3:.2f} us; "
            f"F.scaled_dot_product_attention {d_sdpa * 1e3:.2f} us; bound "
            f"{db_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} "
            f"GFLOP, {db_by})")
    for what, B, Sq, Sk, H, hd in FLASH_WHISPER:
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q = torch.randn((B, Sq, H, hd), generator=gen).to(dev, dtype)
            k, v = (torch.randn((B, Sk, H, hd), generator=gen).to(dev, dtype)
                    for _ in range(2))
            out = flash_attention(q, k, v, causal=False)
            ref = flash_attention_ref(q, k, v, causal=False)
            tol = TOL_FLASH[dname]
            err = float((out.float() - ref.float()).abs().max())
            if not bool(torch.isfinite(out).all()) or not bool(
                    ((out.float() - ref.float()).abs()
                     <= tol + tol * ref.float().abs()).all()):
                fail(f"flash_attention_fwd disagrees with plain at whisper's "
                     f"{what} ({dname}, Sq={Sq}, Sk={Sk}): {err:.3e}")
            worst = max(worst, err)
            if dname == "float32":
                say(f"kernel: flash_attention_fwd whisper {what} f32 B={B} "
                    f"Sq={Sq} Sk={Sk} H={H} hd={hd} bidirectional: max abs "
                    f"err {err:.2e} (tol atol = rtol = {tol:g})")
                continue
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            w_ms = graph_time_ms(lambda: flash_attention(q, k, v,
                                                         causal=False),
                                 per_graph=20)
            w_plain = graph_time_ms(lambda: flash_attention_ref(
                q, k, v, causal=False), per_graph=5)
            w_sdpa = graph_time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt), per_graph=20)
            nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
            ops = 4 * B * H * hd * _attention_pairs(Sq, Sk, False, 0)
            wb_ms, wb_by = _bound(nbytes, ops, "bfloat16")
            say(f"kernel: flash_attention_fwd whisper {what} bf16 B={B} "
                f"Sq={Sq} Sk={Sk} H={H} hd={hd} bidirectional: max abs err "
                f"{err:.2e} (tol atol = rtol = {tol:g}); device time "
                f"{w_ms * 1e3:.2f} us/launch; plain {w_plain * 1e3:.2f} us; "
                f"F.scaled_dot_product_attention {w_sdpa * 1e3:.2f} us; "
                f"bound {wb_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB, "
                f"{ops / 1e9:.3f} GFLOP, {wb_by})")
    # training: the kernel forward with the plain version's gradient
    # recomputed (the backward of a training step), against SDPA's own
    # forward and backward, at the encoder's shape with B 2 (phase 13's)
    B, S, H, hd = 2, 1500, 12, 64
    q, k, v = (torch.randn((B, S, H, hd), generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    k_f, k_fb = fwd_bwd_ms(lambda q, k, v: flash_attention(q, k, v,
                                                           causal=False),
                           (q, k, v))
    s_f, s_fb = fwd_bwd_ms(
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
        tuple(t.transpose(1, 2) for t in (q, k, v)))
    say(f"kernel: flash_attention_fwd training at B={B} S={S} H={H} hd={hd} "
        f"bidirectional bf16, eager: forward {k_f * 1e3:.1f} us, forward + "
        f"the recomputed plain backward {k_fb * 1e3:.1f} us (backward "
        f"{(k_fb - k_f) * 1e3:.1f} us); F.scaled_dot_product_attention "
        f"forward {s_f * 1e3:.1f} us, forward + backward {s_fb * 1e3:.1f} "
        f"us (backward {(s_fb - s_f) * 1e3:.1f} us)")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_fwd.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:76",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


# (B, S, H, p, N): the path's shape first; mamba2-370m's N 128; a ragged S;
# then the wide route (p or N above 128)
SSD_CASES = ((4, 512, 80, 64, 64), (1, 512, 32, 64, 128),
             (2, 200, 80, 64, 64), (2, 128, 80, 64, 64),
             (1, 512, 8, 64, 192), (1, 512, 8, 192, 64),
             (1, 256, 4, 256, 256), (2, 200, 3, 160, 160))
# the wide route's timed shape
SSD_WIDE_TIMED = (2, 512, 16, 256, 256)
# one A per batch row: phase 13's chunk of 4 mamba2-370m clients of B 2
SSD_PER_ROW = (8, 128, 32, 64, 128)


def _ssd_inputs(B, S, H, p, N, gen, dev):
    import torch
    import torch.nn.functional as F

    x = torch.randn((B, S, H, p), generator=gen)
    dt = F.softplus(torch.randn((B, S, H), generator=gen)) * 0.1
    Bm = torch.randn((B, S, N), generator=gen)
    Cm = torch.randn((B, S, N), generator=gen)
    A = -torch.exp(torch.randn((H,), generator=gen))
    return [t.to(dev) for t in (x, dt, Bm, Cm, A)]


def _ssd_ops(B: int, S: int, H: int, p: int, N: int) -> dict:
    """Operations the chunked scan needs for these shapes from a zero
    state, by the rate they run at: the float32 products in 3xTF32 on the
    tensor cores, the elementwise scalings on the CUDA cores. B and C have
    no head axis, so the lower triangle of C·Bᵀ is needed once per
    (b, chunk); per (b, h, chunk) W·x on the lower triangle and the state
    update, and C·state for every chunk after the first. The scalings: the
    triangle by L and by dt, B by dt·decay for the state update, C by
    exp(cum) for C·state."""
    Q, chunks = 128, -(-S // 128)
    tri = Q * (Q + 1) // 2
    products = (B * chunks * tri * 2 * N
                + B * H * (chunks * (tri * 2 * p + Q * N * 2 * p)
                           + (chunks - 1) * Q * N * p * 2))
    scalings = B * H * (chunks * (tri * 2 + Q * N) + (chunks - 1) * Q * N)
    return {"float32_3xtf32": products, "float32": scalings}


def phase_kernel_ssd(dev) -> dict:
    """ssd_scan vs the plain chunked scan at the hybrid prefill's shape
    (B 4, S 512, H 80, p 64, N 64) and around it (N 128, S 200, S 128), and
    on the wide route (p or N 192, 256, 160), y and the final state;
    bitwise: a subset of the heads (A sliced to match)
    equals those heads of the full call, and bf16 inputs give the result of
    their f32 casts; timed at the path's shape (bf16 inputs, as the model
    gives them; those inputs cast to f32 first, as a wrapper without the
    bf16 kernels would; and f32), at mamba2-370m's (H 32, p 64, N 128) and
    on the wide route (p = N = 256) against the bound and the plain version
    (no single PyTorch call computes the scan); one A per batch row at a
    chunk of mamba2-370m clients (`SSD_PER_ROW`) against the plain version,
    each row bitwise its own call, timed beside the shared-A call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops as ssd_ops
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
        heads = torch.tensor([0, H // 3, H - 1], device=dev)
        ys, sts = ssd_scan(x[:, :, heads].contiguous(),
                           dt[:, :, heads].contiguous(), Bm, Cm,
                           A[heads].contiguous())
        if not (torch.equal(ys, y[:, :, heads])
                and torch.equal(sts, st[:, heads])):
            fail(f"ssd_scan heads {heads.tolist()} alone differ from the "
                 f"full call (B={B} S={S} H={H} p={p} N={N})")
        xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
        yb, sb = ssd_scan(xb, dt, Bb, Cb, A)
        yf, sf = ssd_scan(xb.float(), dt, Bb.float(), Cb.float(), A)
        if not (torch.equal(yb, yf) and torch.equal(sb, sf)):
            fail(f"ssd_scan on bf16 inputs differs from their f32 casts "
                 f"(B={B} S={S} H={H} p={p} N={N})")
        say(f"kernel: ssd_scan B={B} S={S} H={H} p={p} N={N}: err / max "
            f"|plain| y {errs[0]:.2e} state {errs[1]:.2e} (tol {TOL_SSD:g}); "
            f"3 heads alone and bf16 inputs bitwise as required")

    row = None
    for B, S, H, p, N in (SSD_CASES[0], SSD_CASES[1], SSD_WIDE_TIMED):
        x, dt, Bm, Cm, A = _ssd_inputs(B, S, H, p, N, gen, dev)
        xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
        h0 = torch.zeros((B, H, p, N), device=dev)
        ms32 = graph_time_ms(lambda: ssd_scan(x, dt, Bm, Cm, A), per_graph=20)
        ms = graph_time_ms(lambda: ssd_scan(xb, dt, Bb, Cb, A), per_graph=20)
        cast_ms = graph_time_ms(lambda: ssd_scan(xb.float(), dt, Bb.float(),
                                                 Cb.float(), A), per_graph=20)
        plain_ms = graph_time_ms(lambda: ssd_chunked(xb, dt, Bb, Cb, A, h0),
                                 per_graph=5)
        eager_ms = cuda_time_ms(lambda: ssd_scan(xb, dt, Bb, Cb, A), 100)
        nbytes = (2 * (x.numel() + Bm.numel() + Cm.numel())
                  + 4 * (dt.numel() + A.numel() + x.numel() + B * H * p * N))
        ops = _ssd_ops(B, S, H, p, N)
        bound_ms, bound_by = _bound(nbytes, ops)
        say(f"kernel: ssd_scan B={B} S={S} H={H} p={p} N={N}, device time "
            f"(3 kernels): bf16 inputs {ms * 1e3:.2f} us/call, the same cast "
            f"to f32 first {cast_ms * 1e3:.2f} us, f32 inputs "
            f"{ms32 * 1e3:.2f} us; plain (chunked, PyTorch) "
            f"{plain_ms * 1e3:.2f} us; no single PyTorch call; bound "
            f"{bound_ms * 1e3:.3f} us ({nbytes / 1e6:.2f} MB with bf16 inputs,"
            f" {ops['float32_3xtf32'] / 1e9:.3f} GFLOP of products in 3xTF32 "
            f"and {ops['float32'] / 1e9:.3f} of scalings on the CUDA cores, "
            f"{bound_by}); one eager call {eager_ms * 1e3:.2f} us")
        if row is None or p > 128:
            for kname in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                          "ssd_chunk_scan_kernel"):
                res = kernel_resources(lambda: ssd_scan(xb, dt, Bb, Cb, A),
                                       kname)
                say(f"kernel: ssd_scan's {kname} (p {p}, N {N}), from the "
                    f"profiler's trace: {res}")
        if row is None:
            row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by}
    # one A per batch row (a_stride H): a chunk of 4 mamba2-370m clients of
    # B 2 folded into the batch, against the plain chunked form with the
    # same (B, H) A and bitwise each row's call with its own (H,) A; the
    # stride-0 view of one row bitwise the shared (H,) call
    B, S, H, p, N = SSD_PER_ROW
    x, dt, Bm, Cm, _ = _ssd_inputs(B, S, H, p, N, gen, dev)
    A = -torch.exp(torch.randn((B, H), generator=gen)).to(dev)
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    _reset(ssd_ops.LAUNCHES)
    y, st = ssd_scan(xb, dt, Bb, Cb, A)
    torch.cuda.synchronize()
    launches = ssd_ops.LAUNCHES["ssd_scan"]
    yr, sr = ssd_chunked(xb, dt, Bb, Cb, A, torch.zeros_like(st))
    errs = [_rel(y, yr), _rel(st, sr)]
    worst = max(worst, float((y - yr).abs().max()),
                float((st - sr).abs().max()))
    if launches != 1 or max(errs) > TOL_SSD:
        fail(f"ssd_scan with one A per row: {launches} launches, err / max "
             f"|plain| y {errs[0]:.2e} state {errs[1]:.2e} (tol {TOL_SSD:g})")
    for b in range(B):
        y1, s1 = ssd_scan(xb[b:b + 1], dt[b:b + 1], Bb[b:b + 1],
                          Cb[b:b + 1], A[b])
        if not (torch.equal(y1[0], y[b]) and torch.equal(s1[0], st[b])):
            fail(f"ssd_scan with one A per row: row {b} differs from its "
                 f"own call with that row's A")
    ys, ss = ssd_scan(xb, dt, Bb, Cb, A[0])
    ye, se = ssd_scan(xb, dt, Bb, Cb, A[0].expand(B, H))
    if not (torch.equal(ys, ye) and torch.equal(ss, se)):
        fail("ssd_scan: a stride-0 (B, H) A differs from the shared (H,) "
             "call")
    row_ms = graph_time_ms(lambda: ssd_scan(xb, dt, Bb, Cb, A), per_graph=20)
    shared_ms = graph_time_ms(lambda: ssd_scan(xb, dt, Bb, Cb, A[0]),
                              per_graph=20)
    h0 = torch.zeros((B, H, p, N), device=dev)
    row_plain_ms = graph_time_ms(
        lambda: ssd_chunked(xb, dt, Bb, Cb, A, h0), per_graph=5)
    nbytes = (2 * (x.numel() + Bm.numel() + Cm.numel())
              + 4 * (dt.numel() + A.numel() + x.numel() + B * H * p * N))
    row_bound, row_by = _bound(nbytes, _ssd_ops(B, S, H, p, N))
    say(f"kernel: ssd_scan with one A per batch row (a chunk of 4 "
        f"mamba2-370m clients x B 2) B={B} S={S} H={H} p={p} N={N}, bf16 "
        f"inputs: err / max |plain| y {errs[0]:.2e} state {errs[1]:.2e} "
        f"(tol {TOL_SSD:g}), {launches} launch, each row bitwise its own "
        f"call, a stride-0 A bitwise the shared call; device time "
        f"{row_ms * 1e3:.2f} us/call, the same call with one shared A "
        f"{shared_ms * 1e3:.2f} us, plain {row_plain_ms * 1e3:.2f} us; bound "
        f"{row_bound * 1e3:.3f} us ({row_by}) ({CARD})")
    # training: the kernel forward with the plain chunked form's gradient
    # recomputed, at zamba2-2.7b's training shape in phase 13 (B 2, S 128)
    x, dt, Bm, Cm, A = _ssd_inputs(2, 128, 80, 64, 64, gen, dev)
    k_f, k_fb = fwd_bwd_ms(ssd_scan, (x, dt, Bm, Cm, A))
    say(f"kernel: ssd_scan training at B=2 S=128 H=80 p=64 N=64 f32, eager: "
        f"forward {k_f * 1e3:.1f} us, forward + the recomputed plain "
        f"backward {k_fb * 1e3:.1f} us (backward {(k_fb - k_f) * 1e3:.1f} "
        f"us)")
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:71",
            "max_abs_err": worst, **row, "library_ms": None}


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
    # every bf16 site through the tensor-core form
    want = {"ssd_scan": cfg.n_layers, "flash_attention_fwd": n_attn_sites(cfg),
            "flash_attention_fwd_tc": n_attn_sites(cfg)}
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
        f"{gen_s:.2f} s; launches {launches} (one per mixer, one per site, "
        f"every site on the tensor cores); "
        f"peak device memory {peak_mb:.0f} MiB; first new tokens "
        f"{new[:, :4].tolist()}")

    # timings, none claimed
    batch = {"tokens": prompts}
    pre = lambda: model.prefill(params, batch, max_len=S0 + steps)  # noqa: E731
    pre_ms = cuda_time_ms(pre, 3, warmup=1)
    pre_dev, pre_wall, kernels = profiled_device_ms(pre, 2, top=None)
    share = {name: sum(ms for k, ms, _ in kernels if name in k)
             for name in ("ssd_", "flash_fwd")}
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
    if dev_launches != {"ssd_scan": 6, "flash_attention_fwd": 1,
                        "flash_attention_fwd_tc": 0}:
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


# dense and MoE decoders at full depth, prefill of 256 + 3 decode steps
# against forward, max abs error relative to the largest logit: the
# hybrid's tolerances. float32: the prefill and forward differ only in the
# order of sums (products of another M, flash over another S). bfloat16:
# the decode step's plain attention rounds the normalised probabilities to
# bf16 where the flash kernel rounds the unnormalised ones, and that
# compounds over 40 layers
TOL_DECODER_CONSISTENT = TOL_HYBRID_CONSISTENT
# the card (kernels) against the CPU (plain versions), full width, 2
# layers, relative to the largest logit: float32 as the hybrid's; bfloat16
# (stablelm-12b, to run flash's wide route, hd 160, inside the model) as
# the reduced models' CPU tests, where the two sides round at different
# places (the flash kernel's P before normalising)
TOL_DECODER_CPU = {"float32": TOL_HYBRID_CPU, "bfloat16": 2e-2}
# a router near tie: the k-th and (k+1)-th probabilities of a token within
# this fraction of the k-th, where the order of a float32 sum can decide
NEAR_TIE = 1e-6
DECODER_ARCHS = ("granite-3-2b", "phi3-mini-3.8b", "phi3-medium-14b",
                 "stablelm-12b", "granite-moe-3b-a800m", "olmoe-1b-7b")
# (name, n_layers, d, heads, kv heads, hd, vocab, parameters) served whole
DECODER_SERVED = (
    ("granite-3-2b", 40, 2048, 32, 8, 64, 49155, 2_534_049_792),
    ("olmoe-1b-7b", 16, 2048, 16, 16, 128, 50304, 6_919_620_608))


class RouteLog:
    """While active, records every `moe.route` call (one per MoE layer and
    call): per routed token, its top-k set (sorted expert ids, from the
    router's own float32 probabilities, in lax.top_k's order), the relative
    gap between its k-th and (k+1)-th probabilities, and how many of its k
    pairs the capacity dropped; with ``keep_combine`` also the call's
    float32 combine weights (before the bf16 rounding of `moe.moe_ffn`).
    Tokens are those of the flattened groups, padding included (`tokens`
    cuts it)."""

    def __init__(self, keep_combine: bool = False):
        self.keep_combine = keep_combine

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route

        def spy(x, p, cfg, capacity=None):
            combine, aux = self._route(x, p, cfg, capacity)
            k = cfg.top_k
            probs = torch.softmax(moe.L.matmul(x.float(),
                                               p["router"]["w"].float()), -1)
            srt, idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
            gap = (srt[..., k - 1] - srt[..., k]) / srt[..., k - 1]
            kept = (combine > 0).flatten(-2).sum(-1)
            self.calls.append({
                "sets": idx[..., :k].sort(-1).values.reshape(-1, k).cpu(),
                "gap": gap.reshape(-1).cpu(),
                "dropped": (k - kept).reshape(-1).cpu()})
            if self.keep_combine:
                self.calls[-1]["combine"] = combine.detach().cpu()
            return combine, aux

        moe.route = spy
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route

    def tokens(self, n: int) -> dict:
        """Each record stacked over the calls (layers), cut to the first n
        tokens: sets (calls, n, k), gap and dropped (calls, n)."""
        import torch

        return {key: torch.stack([c[key][:n] for c in self.calls])
                for key in ("sets", "gap", "dropped")}


# a combine weight that rounds to another bf16 value on the two devices is
# a rounding near tie when its two float32 values agree within this,
# relative: above the sound runs' largest gap (2.60e-6 on the H100) and
# below what a flash output off by its own float32 tolerance reads there
# (1.34e-4, `PlantedFlash`); phase 13 reads both in every run and fails
# unless the bound lies between them
COMBINE_NEAR = 1e-5


class RouteReplay:
    """While active, every `moe.route` call takes the bf16 rounding of the
    combine weights from another run's calls (``calls``, a `RouteLog` with
    ``keep_combine``, in the same order): where the two runs' float32
    weights round to different bf16 values, the weight is moved to the
    other run's value, straight-through (the gradient stays this run's).
    Such a weight is a rounding near tie that the order of a float32 sum
    decided; each must be one (within ``bound`` of the other run's,
    relative), else `fail`; with ``bound=None`` the gaps are only read.
    ``flips`` counts them; ``moved`` counts those where one run routed the
    pair to no expert (another set, or a capacity drop), and ``gap`` is the
    largest relative difference among the rest."""

    def __init__(self, calls, bound=COMBINE_NEAR):
        self.replay, self.bound = calls, bound
        self.flips, self.moved, self.gap = 0, 0, 0.0

    def __enter__(self):
        import torch

        from repro_torch.models import moe

        self._moe, self._route, self._i = moe, moe.route, 0

        def replay(x, p, cfg, capacity=None):
            combine, aux = self._route(x, p, cfg, capacity)
            other = self.replay[self._i]["combine"].to(combine.device)
            self._i += 1
            flip = combine.to(torch.bfloat16) != other.to(torch.bfloat16)
            moved = (combine == 0) != (other == 0)
            n = int(flip.sum())
            if n:
                rel = ((combine.detach() - other).abs() / other.abs())[
                    flip & ~moved]
                if rel.numel():
                    self.gap = max(self.gap, float(rel.max()))
                self.moved += int(moved.sum())
                if self.bound is not None and (self.gap > self.bound
                                               or self.moved):
                    fail(f"combine weights round to another bf16 value with "
                         f"no near tie: relative gap {self.gap:.2e} (near "
                         f"tie <= {self.bound:g}), {self.moved} pairs on "
                         f"another expert")
                self.flips += n
            return combine + torch.where(flip, other - combine,
                                         0.0).detach(), aux

        moe.route = replay
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


class PlantedFlash:
    """While active, a planted fault: every flash output of the attention
    families is off by ``tol`` + ``tol`` · |out| (at ``TOL_FLASH``'s float32
    value, the edge of phase 3's check), with a fixed ±1 sign pattern, so
    that the recomputation under remat sees the same output. Used only to
    read what `RouteReplay`'s bound has to catch."""

    def __init__(self, tol: float):
        self.tol = tol

    def __enter__(self):
        import torch

        from repro_torch.models import transformer

        self._mod, self._flash = transformer, transformer.flash_attention

        def planted(q, k, v, **kw):
            out = self._flash(q, k, v, **kw)
            g = torch.Generator(device=out.device).manual_seed(0)
            sign = torch.randint(0, 2, out.shape, generator=g,
                                 device=out.device) * 2 - 1
            return out + (self.tol * (1 + out.detach().abs()) * sign).to(
                out.dtype)

        transformer.flash_attention = planted
        return self

    def __exit__(self, *exc):
        self._mod.flash_attention = self._flash


def _moe_capacity(cfg) -> int:
    """The capacity the inference path gives a full group of 512."""
    from repro_torch.models import moe

    return moe._capacity(moe.MOE_GROUP, cfg.n_experts, cfg.top_k,
                         moe.INFERENCE_CAPACITY_FACTOR)


def _clean_prefix(bad):
    """bad (rows, positions) bool → clean (rows, positions): no bad
    position at or before it in its row."""
    return bad.int().cumsum(-1) == 0


def _decoder_consistency(model, params, toks, n_pre: int, moe: bool):
    """A prefill of the first ``n_pre`` tokens of ``toks`` (B, S) plus 3
    decode steps against ``forward`` over all S (the MoE's on its inference
    path, ``dropless``), at full depth. For the MoE, a row is held only up
    to the first token that the two paths routed differently (a dropped
    pair, or another top-k set: a near tie that the products' order
    decided); both are counted and printed. Returns the errors relative to
    the largest logit at positions n_pre - 1 .. n_pre + 2 (None where no
    row is held) and a note for the line printed."""
    import torch

    B, S = toks.shape
    checked = list(range(n_pre - 1, n_pre + 3))
    held = torch.ones((B, 4), dtype=torch.bool)
    note = ""
    with RouteLog() as fwd_log:
        full = model.forward(params, {"tokens": toks},
                             **({"dropless": True} if moe else {}))
    with RouteLog() as pre_log:
        last, cache = model.prefill(params, {"tokens": toks[:, :n_pre]},
                                    max_len=S)
    outs = [last]
    with RouteLog() as dec_log:
        for t in checked[1:]:
            lg, cache = model.decode_step(params, toks[:, t], cache)
            outs.append(lg)
    del cache
    if moe:
        f, p = fwd_log.tokens(B * S), pre_log.tokens(B * n_pre)
        k = f["sets"].shape[-1]
        if int(dec_log.tokens(B)["dropped"].sum()):
            fail("a decode step dropped a pair: it must route dropless")
        f_drop = (f["dropped"] > 0).any(0).reshape(B, S)
        p_drop = (p["dropped"] > 0).any(0).reshape(B, n_pre)
        moved = (f["sets"].reshape(-1, B, S, k)[:, :, :n_pre]
                 != p["sets"].reshape(-1, B, n_pre, k)).any(-1).any(0)
        bad = f_drop.clone()
        bad[:, :n_pre] |= p_drop | moved
        held = _clean_prefix(bad)[:, checked]
        note = (f"; dropped pairs: forward {int(f['dropped'].sum())}, "
                f"prefill {int(p['dropped'].sum())}; tokens the two paths "
                f"routed to another top-k set {int(moved.sum())}; logits held "
                f"in {int(held.sum())} of {held.numel()} (row, position)s")
    scale = float(full.float().abs().max())
    errs = []
    for j, (t, lg) in enumerate(zip(checked, outs)):
        rows = held[:, j]
        errs.append(float((lg[rows].float() - full[rows, t].float()).abs()
                          .max()) / scale if bool(rows.any()) else None)
    return errs, note


def phase_decoder(dev) -> dict:
    """granite-3-2b and olmoe-1b-7b at their published widths and full
    depth through generate (flash once per layer in the prefill, every
    launch on the tensor cores, none in the decode steps), prefill plus
    decode against forward (f32 and bf16), timings; then all six decoder
    configs card against CPU at full width and 2 layers. Returns the flash
    launches of the two served prefills."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.serve import generate
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute, with_compute_copies
    from repro_torch.utils.pytree import tree_size

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = 0
    for name, n_layers, d, H, KV, hd, vocab, n_want in DECODER_SERVED:
        cfg = get_config(name)
        moe = cfg.family == "moe"
        widths = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                  cfg.head_dim, cfg.vocab, cfg.compute_dtype)
        if widths != (n_layers, d, H, KV, hd, vocab, "bfloat16"):
            fail(f"unexpected {name} widths: {widths}")
        model = build(cfg)
        torch.cuda.synchronize()
        base_mb = torch.cuda.memory_allocated() / 2 ** 20
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = tree_size(strip_compute(params))
        if n_params != n_want:
            fail(f"{name}: {n_params} parameters, expected {n_want}")
        weights_mb = torch.cuda.memory_allocated() / 2 ** 20 - base_mb

        B, S0, steps = 4, 512, 16
        rng = np.random.default_rng(7)
        prompts = torch.from_numpy(rng.integers(4, cfg.vocab,
                                                (B, S0))).to(dev)
        temps = [0.0, 0.0, 0.8, 0.8]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for k in fa_ops.LAUNCHES:
            fa_ops.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        out = generate(model, params, prompts, steps, temperature=temps,
                       seed=11)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        got = dict(fa_ops.LAUNCHES)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        want = {"flash_attention_fwd": n_layers,
                "flash_attention_fwd_tc": n_layers}
        if got != want:
            fail(f"{name}: generate launched {got}, expected {want} (one "
                 f"prefill, none in the decode steps)")
        launches += got["flash_attention_fwd"]
        if tuple(out.shape) != (B, S0 + steps) or not torch.equal(
                out[:, :S0], prompts):
            fail(f"{name}: generate returned {tuple(out.shape)} or changed "
                 f"the prompts")
        new = out[:, S0:]
        if int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
            fail(f"{name}: generated ids outside [0, {cfg.vocab})")
        kind = (f"{cfg.n_experts} experts top-{cfg.top_k} (d_ff "
                f"{cfg.expert_d_ff})" if moe else f"d_ff {cfg.d_ff}")
        say(f"decoder: {name} {n_layers} layers, d {d}, {H} x hd {hd} heads "
            f"({KV} KV), {kind}, vocab {vocab}, bf16: {n_params} parameters "
            f"drawn on the card in {init_s:.2f} s ({weights_mb:.0f} MiB with "
            f"the bf16 copies); generate {B} x {S0} prompts + {steps} tokens "
            f"(temperatures {temps}) in {gen_s:.2f} s; flash launches {got} "
            f"(one per layer in the prefill, all on the tensor cores, none "
            f"in the decode steps); peak device memory {peak_mb:.0f} MiB; "
            f"first new tokens {new[:, :4].tolist()}")

        # timings, none claimed
        batch = {"tokens": prompts}
        pre = lambda: model.prefill(params, batch, max_len=S0 + steps)  # noqa: E731
        pre_ms = cuda_time_ms(pre, 3, warmup=1)
        pre_dev, _, kernels = profiled_device_ms(pre, 1, top=6)
        _, cache = pre()
        tok = out[:, S0]
        dec = lambda: model.decode_step(params, tok, cache)  # noqa: E731
        dec_ms = cuda_time_ms(dec, 5, warmup=2)
        dec_dev, _, dec_top = profiled_device_ms(dec, 3, top=4)
        gen_dev, gen_wall, _ = profiled_device_ms(
            lambda: generate(model, params, prompts, steps,
                             temperature=temps, seed=11), 1, warmup=False,
            top=1, cpu=False)
        flash_ms = sum(ms for k, ms, _ in kernels if "flash_fwd" in k)
        say(f"decoder: {name} prefill {B} x {S0} {pre_ms:.2f} ms eager "
            f"({B * S0 / pre_ms * 1e3:.0f} tokens/s), {_fmt_ms(pre_dev)} on "
            f"the device; decode step at B={B} {dec_ms:.2f} ms eager, "
            f"{_fmt_ms(dec_dev)} on the device ({B / dec_ms * 1e3:.0f} "
            f"tokens/s); generate {B * steps / gen_s:.1f} generated tokens/s "
            f"with its prefill; device busy "
            f"{'not measured' if gen_dev is None else f'{100 * gen_dev / gen_wall:.1f}%'}"
            f" of a profiled generate ({_fmt_ms(gen_dev)} of "
            f"{gen_wall:.1f} ms)")
        say(f"decoder: {name} device time of one prefill by kernel (flash "
            f"{flash_ms * 1e3:.1f} us in the top six): " + "; ".join(
                f"{k} {ms * 1e3:.1f} us x{n:g}" for k, ms, n in kernels))
        say(f"decoder: {name} device time of one decode step by kernel: "
            + "; ".join(f"{k} {ms * 1e3:.1f} us x{n:g}"
                        for k, ms, n in dec_top))
        del cache
        if moe:
            with RouteLog() as log:
                pre()
            drops = log.tokens(B * S0)["dropped"]
            say(f"decoder: {name} prefill {B} x {S0}: groups of 512 routed "
                f"at capacity {_moe_capacity(cfg)}: {int(drops.sum())} of "
                f"{drops.numel() * cfg.top_k} token-expert pairs dropped "
                f"(per layer {drops.sum(1).tolist()}); a decode step drops "
                f"none")

        # prefill + decode against forward at full depth: the MoE at 2 x
        # 64 tokens, one group of 128, which its inference path routes
        # dropless (a larger group drops pairs, counted above)
        B_c, S_c, n_pre = (2, 64, 48) if moe else (4, 384, 256)
        toks = torch.from_numpy(rng.integers(4, cfg.vocab,
                                             (B_c, S_c))).to(dev)
        m32 = build(cfg.with_(compute_dtype="float32"))
        p32 = with_compute_copies(strip_compute(params), "float32",
                                  m32.compute_copies)
        for dname, m, p in (("float32", m32, p32), ("bfloat16", model,
                                                    params)):
            errs, note = _decoder_consistency(m, p, toks, n_pre, moe)
            tol = TOL_DECODER_CONSISTENT[dname]
            held = [e for e in errs if e is not None]
            # a float32 check must hold something; in bfloat16 the MoE's
            # router reads activations rounded differently on the two
            # paths, and near ties may leave no row clean (counted)
            if (dname == "float32" and len(held) < len(errs)) or not all(
                    np.isfinite(held)) or max(held, default=0.0) > tol:
                fail(f"{name} {dname}: prefill + decode disagree with "
                     f"forward: {errs} (tol {tol:g}){note}")
            say(f"decoder: {name} {dname}, full depth, prefill of {n_pre} + "
                f"3 decode steps against forward over {S_c} tokens, "
                f"B={B_c}: max abs err / max |logit| "
                f"{', '.join('not held' if e is None else f'{e:.2e}' for e in errs)}"
                f" (tol {tol:g}){note}")
        del p32, params, m32
        torch.cuda.empty_cache()

    # the card's kernels against the CPU's plain versions: full width, 2
    # layers, float32 (and stablelm-12b in bf16 too), B 2, S 64: a group of
    # 128 tokens, so the MoE routes dropless
    for name in DECODER_ARCHS:
        for dname in (("float32", "bfloat16") if name == "stablelm-12b"
                      else ("float32",)):
            _decoder_card_vs_cpu(dev, get_config(name), dname)
    say(f"decoder: phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _decoder_card_vs_cpu(dev, cfg, dname: str) -> None:
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute, with_compute_copies
    from repro_torch.utils.pytree import tree_map

    cfg = cfg.with_(n_layers=2, compute_dtype=dname)
    moe = cfg.family == "moe"
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    B, S = 2, 64
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        4, cfg.vocab, (B, S)))
    kw = {"dropless": True} if moe else {}
    for k in fa_ops.LAUNCHES:
        fa_ops.LAUNCHES[k] = 0
    with RouteLog() as card_log:
        lg_dev = model.forward(params, {"tokens": toks.to(dev)}, **kw)
    torch.cuda.synchronize()
    want = {"flash_attention_fwd": 2,
            "flash_attention_fwd_tc": 2 * (dname == "bfloat16")}
    if fa_ops.LAUNCHES != want:
        fail(f"{cfg.name} 2 layers {dname}: the card forward launched "
             f"{dict(fa_ops.LAUNCHES)}, expected {want}")
    cpu_p = with_compute_copies(tree_map(lambda t: t.cpu(),
                                         strip_compute(params)), dname,
                                model.compute_copies)
    del params
    t0 = time.perf_counter()
    with RouteLog() as cpu_log:
        lg_cpu = model.forward(cpu_p, {"tokens": toks}, **kw)
    cpu_s = time.perf_counter() - t0
    del cpu_p
    held = torch.ones((B, S), dtype=torch.bool)
    note = ""
    if moe:
        c, h = card_log.tokens(B * S), cpu_log.tokens(B * S)
        if int(c["dropped"].sum()) or int(h["dropped"].sum()):
            fail(f"{cfg.name}: a group of {B * S} tokens dropped a pair")
        differ = (c["sets"] != h["sets"]).any(-1)          # (layers, tokens)
        near = h["gap"] <= NEAR_TIE
        if bool((differ & ~near).any()):
            fail(f"{cfg.name}: {int((differ & ~near).sum())} tokens routed "
                 f"to another top-k set on the card with no near tie (gap > "
                 f"{NEAR_TIE:g})")
        held = _clean_prefix(differ.any(0).reshape(B, S))
        note = (f"; MoE routing: {int(differ.sum())} token-layers with "
                f"another top-k set on the card, all near ties; {int(near.sum())} "
                f"near ties (gap <= {NEAR_TIE:g}) of {near.numel()} "
                f"token-layers; logits held at {int(held.sum())} of {B * S} "
                f"positions")
    lg_dev = lg_dev.cpu()
    err = float((lg_dev[held].float() - lg_cpu[held].float()).abs().max()
                / lg_cpu.float().abs().max())
    tol = TOL_DECODER_CPU[dname]
    if not err <= tol:
        fail(f"{cfg.name}: card and CPU disagree at 2 layers, {dname}: "
             f"{err:.3e} (tol {tol:g}){note}")
    say(f"decoder: {cfg.name} card (flash_attention_fwd, hd {cfg.head_dim}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads) against CPU (plain), full "
        f"width, 2 layers, {dname}, B={B} S={S}: max abs err / max |logit| "
        f"{err:.2e} (tol {tol:g}); the CPU took {cpu_s:.1f} s{note}")


# the card (kernels) against the CPU (plain versions) on canary scores at
# full width, bf16 products: max abs error relative to the largest score
# (the float32 sums run in another order, and a one-ulp flip of a bf16
# rounding of h moves a score by far less than this; 9.8e-7 was measured on
# an H100). A pool score (or a beam's) within this tolerance of the one it
# is ranked against is a near tie, where the two sides may rank differently
TOL_SCORE = 1e-4


class HostDraws:
    """The host trainer's draws behind the engine's draw methods
    (`repro_torch.fl.engine.EngineDraws`): its numpy sampling
    (`fl.sampling.sample_round` over its own `PopulationSim`), the
    permutations of `FederatedDataset.user_tensor` as per-slot example
    indices, and its noise generator on the card. Handed to the engine, they
    give it the host trainer's cohorts, batches and noise."""

    def __init__(self, ds, pop, seed, cohort, need, dev):
        import numpy as np
        import torch

        self.ds, self.pop, self.size, self.need, self.dev = \
            ds, pop, cohort, need, dev
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def begin_round(self, round_idx):
        import numpy as np

        from repro_torch.fl.sampling import sample_round

        self.ids = sample_round(self.pop, self.rng, round_idx, self.size)
        self.idx = np.stack([self.rng.permutation(np.resize(np.arange(
            self.ds.users[int(u)].examples.shape[0]), self.need))
            for u in self.ids])

    def available(self, n):
        import torch

        return torch.zeros((n,), device=self.dev)

    def cohort(self, weights, available, cohort):
        import torch

        return torch.from_numpy(self.ids).to(self.dev)

    def example_indices(self, counts, need):
        import torch

        return torch.from_numpy(self.idx).to(self.dev)

    def noise(self, like, std):
        from repro_torch.utils.pytree import tree_noise

        return tree_noise(self.gen, like, std)


def _same_tree(a, b) -> bool:
    import torch

    from repro_torch.utils.pytree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _same_hist(a, b) -> bool:
    import numpy as np

    if set(a) != set(b):
        return False
    return all(_same_hist(a[k], b[k]) if isinstance(a[k], dict)
               else np.array_equal(a[k], b[k]) for k in a)


def _pool_scores(model, params, toks, pool, batch: int):
    """(K, n) canary-prefixed pool scores, ``batch`` continuations a
    forward."""
    import torch

    from repro_torch.core.secret_sharer import PREFIX_LEN, score_canaries

    K, out = toks.shape[0], []
    for i in range(0, pool.shape[0], batch):
        c = pool[i:i + batch]
        seqs = torch.cat([toks[:, None, :PREFIX_LEN].expand(K, c.shape[0],
                                                           PREFIX_LEN),
                          c[None].expand(K, c.shape[0], c.shape[1])], dim=-1)
        out.append(score_canaries(model, params, seqs.reshape(-1, 5)
                                  ).reshape(K, -1))
    return torch.cat(out, dim=1)


def phase_memorize(dev, n_users: int = 1000, cohort: int = 128,
                   vocab: int = 10_000, rounds: int = 10, per_call: int = 5,
                   rs_samples: int = 500_000, pool_n: int = 4096) -> dict:
    """The Secret Sharer at full width of gboard-cifg-lstm: DP-FedAvg on
    1000 users plus the paper's 27 canaries (189 synthetic devices) through
    FederatedTrainer(backend="engine") with the canary eval hook, then
    Random-Sampling ranks at |R| = rs_samples and beam-search extraction.
    Checks: run against run_python bitwise; the engine against the host
    trainer on its draws bitwise; the round bitwise across cohort_chunk;
    the noise std; launch counts; scores, RS ranks on a pool and the
    top-5 beams card against CPU."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.core.secret_sharer import (canary_eval_fn,
                                                canary_extracted,
                                                canary_matrix, beam_search,
                                                make_canaries,
                                                random_sampling_ranks,
                                                score_canaries)
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fl.engine import SimEngine
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.round import FederatedTrainer
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.models import build
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_zeros_like

    cfg = get_config("gboard-cifg-lstm")
    if vocab != cfg.vocab:
        cfg = cfg.with_(vocab=vocab)
    model = build(cfg)
    seq_len, batch, n_batches = 16, 10, 3
    t0 = time.perf_counter()
    ds = FederatedDataset(BigramCorpus(vocab_size=cfg.vocab, seed=0),
                          n_users=n_users, seq_len=seq_len,
                          sentences_per_user=30)
    canaries = make_canaries(torch.Generator().manual_seed(42), cfg.vocab)
    synth_users = ds.inject_canaries(canaries)
    synth = [u.user_id for u in synth_users]
    data_s = time.perf_counter() - t0
    K = len(canaries)
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                  server_momentum=0.9)
    cl = ClientConfig(local_epochs=1, batch_size=batch, lr=0.3)
    need = n_batches * batch

    def pop():
        return PopulationSim(len(ds.users), availability=0.3,
                             synthetic_ids=synth, seed=0)

    def trainer(backend, **kw):
        return FederatedTrainer(model, ds, dp, cl, pop=pop(), seed=0,
                                n_local_batches=n_batches, backend=backend,
                                rounds_per_call=per_call, device=dev, **kw)

    # run against run_python: same seed, 5 rounds, bitwise; host syncs
    tr = trainer("engine")
    eng = tr.engine
    params0 = tr.state.params
    syncs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {}
    for how in ("run", "run_python"):
        state = eng.init_state(params0, seed=0)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out[how] = getattr(eng, how)(state, per_call)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs[how] = sum("synchroniz" in str(w.message) for w in caught)
    (sa, ha), (sb, hb) = out["run"], out["run_python"]
    if not (_same_tree(sa.params, sb.params)
            and _same_tree(sa.opt_state.momentum, sb.opt_state.momentum)
            and _same_tree(sa.opt_state.nu, sb.opt_state.nu)
            and sa.opt_state.count == sb.opt_state.count
            and _same_hist(ha, hb)
            and torch.equal(sa.participation, sb.participation)):
        fail("engine run and run_python differ after 5 rounds")
    say(f"memorize: engine run ({per_call} rounds a call) and run_python (a "
        f"read every round), same seed, {per_call} rounds: params, optimizer "
        f"state and history bitwise equal; synchronizing operations flagged "
        f"by torch.cuda's sync debug mode: run {syncs['run']} "
        f"({syncs['run'] / per_call:.1f} a round), run_python "
        f"{syncs['run_python']} ({syncs['run_python'] / per_call:.1f} a "
        f"round); {time.perf_counter() - t0:.1f} s")

    # the engine against the host trainer, both on the card, 3 rounds: the
    # engine takes the host trainer's cohorts, batches and noise
    t0 = time.perf_counter()
    host = trainer("host")
    host.train(3)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mirror = trainer("engine", draws=HostDraws(ds, pop(), 0, cohort, need,
                                               dev))
    mirror.train(3)
    torch.cuda.synchronize()
    mirror_s = time.perf_counter() - t0
    if not _same_tree(mirror.state.params, host.state.params):
        d = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(mirror.state.params),
                    tree_leaves(host.state.params)))
        fail(f"engine on the host trainer's draws differs from the host "
             f"trainer after 3 rounds (max abs diff {d:.3e})")
    if [r["loss"] for r in mirror.state.history] != \
            [r["loss"] for r in host.state.history]:
        fail("engine and host trainer losses differ")
    if not np.array_equal(mirror.participation, host.participation):
        fail("engine and host trainer participation differ")
    say(f"memorize: the engine on the host trainer's draws (cohorts, "
        f"example indices, noise) against FederatedTrainer(backend='host'), "
        f"3 rounds on the card: params, losses and participation bitwise "
        f"equal; host trainer {3 / host_s:.3f} rounds/s, engine "
        f"{3 / mirror_s:.3f} rounds/s on the same draws")

    # the round sum across cohort_chunk: one round from one seed, bitwise
    t0 = time.perf_counter()
    blk = eng.padded // 8
    chunks = [c for c in (1, 4, 16) if blk % c == 0]
    ref = None
    for c in chunks:
        e = SimEngine(model, ds.to_device_arrays(), dp, cl,
                      n_local_batches=n_batches, availability=0.3,
                      cohort_chunk=c, device=dev)
        got = e.run(e.init_state(params0, seed=5), 1)
        if ref is None:
            ref = got
        elif not (_same_tree(got[0].params, ref[0].params)
                  and _same_hist(got[1], ref[1])):
            fail(f"engine round differs between cohort_chunk {chunks[0]} "
                 f"and {c}")
    say(f"memorize: an engine round bitwise equal across cohort_chunk "
        f"{chunks} (block size {blk}) in {time.perf_counter() - t0:.1f} s")

    sigma = dp.noise_multiplier * dp.clip_norm / cohort
    noise = eng.init_state(params0, seed=9).draws.noise(
        tree_zeros_like(params0, torch.float32), sigma)
    flat = torch.cat([l.reshape(-1) for l in tree_leaves(noise)])
    std = float(flat.std())
    if abs(std / sigma - 1.0) > 0.02:
        fail(f"engine noise std {std:.4e} vs zS/qN {sigma:.4e}")
    say(f"memorize: engine noise std over {flat.numel()} entries {std:.5e} "
        f"vs zS/qN {sigma:.5e} ({100 * (std / sigma - 1):+.2f}%, tol 2%)")
    del tr, eng, out, sa, sb, host, mirror, ref, e, got, noise, flat

    # ------------------------------------------------ the counted main path
    counters = (cell_ops.LAUNCHES, clip_ops.LAUNCHES)
    main = trainer("engine", eval_fn=canary_eval_fn(model, canaries),
                   eval_every=per_call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    for c in counters:
        for k in c:
            c[k] = 0
    t0 = time.perf_counter()
    main.train(rounds)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    params = main.state.params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ranks = random_sampling_ranks(
        model, params, canaries,
        torch.Generator(device=dev).manual_seed(7), n_samples=rs_samples,
        batch_size=1024)
    torch.cuda.synchronize()
    rs_s = time.perf_counter() - t0
    rs_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    t0 = time.perf_counter()
    extracted = [canary_extracted(model, params, c) for c in canaries]
    beam_s = time.perf_counter() - t0
    launches = {**cell_ops.LAUNCHES, **clip_ops.LAUNCHES}

    hist = main.state.history
    if any(r["n_clients"] != cohort for r in hist) or cohort % 8:
        fail(f"rounds of {[r['n_clients'] for r in hist]} clients")
    if not all(np.isfinite(r["loss"]) for r in hist):
        fail("memorize: training losses not finite")
    if main.accountant.rounds != rounds:
        fail(f"accountant took {main.accountant.rounds} steps, not {rounds}")
    if main.participation.sum() != rounds * cohort:
        fail("participation not mirrored back from the engine")
    chunks = rounds * main.engine.padded // main.engine.cohort_chunk
    evals = rounds // per_call
    rs_chunks = -(-rs_samples // 1024)
    beam_steps = K * 3
    # one launch of each cell kernel per chunk and local batch: the chunk's
    # clients train as one program
    chunk_batches = chunks * n_batches
    want = {"cifg_cell_bwd_seq": chunk_batches, "cifg_cell_bwd": 0,
            "cifg_cell_fwd": chunk_batches + evals + 1 + rs_chunks
            + beam_steps,
            "dp_sumsq": chunks, "dp_clip_accumulate": 5 * chunks}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"memorize launched {k} {launches[k]} times, expected {v}")
    ev = main.eval_history
    if not (ev["mask"].tolist() == [(r + 1) % per_call == 0
                                    for r in range(rounds)]
            and ev["values"]["canary_logppl"].shape == (rounds, K)):
        fail("memorize: eval history malformed")
    grid = list(dict.fromkeys((c.n_u, c.n_e) for c in canaries))
    vals = ev["values"]["canary_logppl"][ev["mask"]]
    say(f"memorize: gboard-cifg-lstm vocab {cfg.vocab} (padded "
        f"{-(-cfg.vocab // 256) * 256}) d {cfg.d_model} H {cfg.d_ff} "
        f"{cfg.compute_dtype}; {n_users} users + {K} canaries on "
        f"{len(synth)} synthetic devices (made in {data_s:.1f} s), cohort "
        f"{cohort}, {n_batches} batches of {batch} x {seq_len}, z 0.3, S "
        f"0.8: {rounds} rounds through FederatedTrainer(backend='engine'), "
        f"{per_call} a call, in {train_s:.2f} s = {rounds / train_s:.3f} "
        f"rounds/s (the host trainer {3 / host_s:.3f} rounds/s above); "
        f"losses {[round(r['loss'], 4) for r in hist[::5]]}...; "
        f"eps {main.accountant.get_epsilon(1e-6):.2f} at delta 1e-6")
    for i, r in enumerate(np.nonzero(ev["mask"])[0]):
        per = [float(np.mean([v for v, c in zip(vals[i], canaries)
                              if (c.n_u, c.n_e) == g])) for g in grid]
        say(f"memorize: canary log-perplexity after round {r + 1}, mean of "
            f"3 per (n_u, n_e): " + ", ".join(
                f"{g}: {p:.3f}" for g, p in zip(grid, per)))
    say(f"memorize: Random-Sampling ranks at |R| = {rs_samples} "
        f"({rs_chunks} chunks of 1024 x {K} canaries, sequences of 5): "
        f"{ranks.tolist()}; pass {rs_s:.2f} s = "
        f"{rs_samples * K / rs_s:.0f} sequences/s; peak device memory "
        f"{rs_peak:.0f} MiB")
    say(f"memorize: beam search (width 5) extracted {sum(extracted)} of {K} "
        f"canaries in {beam_s:.2f} s")
    # where an RS chunk's time goes (outside the counted path)
    conts = torch.randint(0, cfg.vocab, (1024, 3), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(8))
    chunk_toks = torch.from_numpy(canary_matrix(canaries)).to(dev)
    chunk_dev, chunk_wall, chunk_top = profiled_device_ms(
        lambda: _pool_scores(model, params, chunk_toks, conts, 1024), 3)
    say(f"memorize: one RS chunk (B {K * 1024}, S 5) under the profiler: "
        f"{_fmt_ms(chunk_dev)} on the device of {chunk_wall:.1f} ms; by "
        f"kernel: " + "; ".join(f"{n} {ms * 1e3:.1f} us x{c:g}"
                                for n, ms, c in chunk_top))
    say(f"memorize: launches {launches} = {chunk_batches} (chunk, local "
        f"batch) programs, "
        f"{evals} eval hooks, 1 + {rs_chunks} RS forwards, {beam_steps} beam "
        f"steps, {chunks} chunks of {main.engine.cohort_chunk} clients; peak "
        f"device memory in training {train_peak:.0f} MiB "
        f"({train_peak - base_mb:.0f} above what was allocated before)")

    round_dev, round_wall, top = profiled_device_ms(lambda: main.train(1), 1,
                                                    warmup=False, cpu=False)
    busy = None if round_dev is None else 100 * round_dev / round_wall
    say(f"memorize: one engine round under the profiler (device activity "
        f"only): "
        f"{_fmt_ms(round_dev)} on the device of {round_wall:.1f} ms, device "
        f"busy {'not measured' if busy is None else f'{busy:.1f}%'}; by "
        f"kernel: " + "; ".join(f"{n} {ms * 1e3:.1f} us x{c:g}"
                                for n, ms, c in top))

    # ------------------------------------- card (kernels) against the CPU
    cpu = torch.device("cpu")
    p_cpu = tree_map(lambda l: l.cpu(), params)
    toks = torch.from_numpy(canary_matrix(canaries)).to(dev)
    s_dev = score_canaries(model, params, toks).cpu()
    s_cpu = score_canaries(model, p_cpu, toks.cpu())
    scale = float(s_cpu.abs().max())
    err = float((s_dev - s_cpu).abs().max()) / scale
    if not err <= TOL_SCORE:
        fail(f"canary scores, card vs CPU: {err:.3e} of the largest > "
             f"{TOL_SCORE:g}")
    say(f"memorize: score_canaries card (cifg_cell_fwd) vs CPU (plain) on "
        f"the trained params, full width: max abs err {err:.2e} of the "
        f"largest score {scale:.3f} (tol {TOL_SCORE:g})")
    pool = torch.randint(0, cfg.vocab, (pool_n, 3),
                         generator=torch.Generator().manual_seed(11))
    r_dev = random_sampling_ranks(model, params, canaries,
                                  continuations=pool.to(dev))
    t0 = time.perf_counter()
    ps_cpu = _pool_scores(model, p_cpu, toks.cpu(), pool, 128)
    r_cpu = (ps_cpu < s_cpu[:, None]).sum(dim=1).numpy()
    near = ((ps_cpu - s_cpu[:, None]).abs() <= TOL_SCORE * scale).sum(1
                                                                      ).numpy()
    off = np.abs(r_dev - r_cpu)
    if np.any(off > near):
        fail(f"RS ranks on a pool of {pool_n}, card {r_dev.tolist()} vs CPU "
             f"{r_cpu.tolist()}, near ties {near.tolist()}")
    say(f"memorize: RS ranks on a pool of {pool_n} continuations, card vs "
        f"CPU: {int((off == 0).sum())} of {K} equal; pool scores within the "
        f"tolerance of their canary's (near ties): {int(near.sum())} in all "
        f"({near.tolist()}); the CPU took {time.perf_counter() - t0:.1f} s")
    ties = 0
    for c in canaries:
        b_dev = beam_search(model, params, c.prefix, 5)
        b_cpu = beam_search(model, p_cpu, c.prefix, 5)
        if b_dev == b_cpu:
            continue
        seqs = np.asarray(sorted(set(b_dev) | set(b_cpu)), np.int32)
        sc = dict(zip(map(tuple, seqs.tolist()),
                      score_canaries(model, p_cpu, seqs).tolist()))
        for a, b in zip(b_dev, b_cpu):
            if a != b:
                if abs(sc[a] - sc[b]) > TOL_SCORE * scale:
                    fail(f"beams of prefix {c.prefix} differ beyond a near "
                         f"tie: card {b_dev} vs CPU {b_cpu}")
                ties += 1
    say(f"memorize: top-5 beams of all {K} prefixes, card vs CPU: equal "
        f"but for {ties} near-tied positions")
    return {"launches": launches, "rounds_per_s": rounds / train_s}


# a fault-on round, card against CPU on one stream of draws: the round's
# parameter change (z = 0, so the change is the server step of the mean
# clipped update) as relative L2, the counts exactly, the rest as TOL_ROUND
FAULT_CFG = dict(seed=7, dropout_prob=0.1, straggler_prob=0.2,
                 straggler_mean_delay=1.0, round_deadline=3.0,
                 corrupt_prob=0.05)


def _kwargs(kw: dict) -> str:
    return ", ".join(f"{k}={v}" for k, v in kw.items())


def _sha256(path) -> str:
    import hashlib

    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def phase_faults(dev, n_users: int = 1000, cohort: int = 128,
                 vocab: int = 10_000, rounds: int = 10,
                 per_call: int = 5) -> dict:
    """The deployed round protocol at full width of gboard-cifg-lstm:
    over-selection, the report goal, corrupt reports through the guard,
    aborts that change nothing, σ on the goal, and crash-resume (in process
    and through the CLI)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.fl.faults import (FaultConfig, fault_fates,
                                       fault_generator)
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.round import FederatedTrainer
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.models import build
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t_phase = time.perf_counter()
    cfg = get_config("gboard-cifg-lstm")
    if vocab != cfg.vocab:
        cfg = cfg.with_(vocab=vocab)
    model = build(cfg)
    seq_len, batch, n_batches = 16, 10, 3
    ds = FederatedDataset(BigramCorpus(vocab_size=cfg.vocab, seed=0),
                          n_users=n_users, seq_len=seq_len,
                          sentences_per_user=30)
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                  server_momentum=0.9)
    cl = ClientConfig(local_epochs=1, batch_size=batch, lr=0.3)
    fc = FaultConfig(**FAULT_CFG)

    def trainer(faults=fc, **kw):
        return FederatedTrainer(
            model, ds, dp, cl, pop=PopulationSim(n_users, availability=0.3,
                                                 seed=0),
            seed=0, n_local_batches=n_batches, backend="engine",
            rounds_per_call=per_call, device=dev, fault_config=faults, **kw)

    # ------------------------------------------------ the counted main path
    main = trainer()
    eng = main.engine
    goal = eng.report_goal
    sizes = (fc.over_selection(cohort), fc.resolve_report_goal(cohort))
    if (eng.sel_cohort, goal) != sizes or (
            cohort == 128 and sizes != (152, 103)) or eng.padded % 8:
        fail(f"faults: {eng.sel_cohort} selected (padded {eng.padded}), "
             f"report goal {goal}; expected 152 and 103 at cohort 128")
    params0 = tree_map(torch.clone, main.state.params)
    setup_s = time.perf_counter() - t_phase
    counters = (cell_ops.LAUNCHES, clip_ops.LAUNCHES)
    torch.cuda.synchronize()
    for c in counters:
        for k in c:
            c[k] = 0
    # a run-state snapshot 3 rounds before the end, resumed below
    cut = rounds - 3
    t0 = time.perf_counter()
    main.train(cut)
    torch.cuda.synchronize()
    mid_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        state_path = Path(tmp) / "state.msgpack"
        main.save_run_state(state_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main.train(rounds - cut)
        torch.cuda.synchronize()
        train_s = mid_s + time.perf_counter() - t0
        launches = {**cell_ops.LAUNCHES, **clip_ops.LAUNCHES}
        t0 = time.perf_counter()
        resumed = trainer()
        if resumed.restore_run_state(state_path) != cut:
            fail("faults: restore_run_state returned another round")
        resumed.train(rounds - cut)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    if not (_same_tree(resumed.state.params, main.state.params)
            and _same_tree(resumed.state.opt_state.momentum,
                           main.state.opt_state.momentum)
            and resumed.state.history == main.state.history
            and resumed.accountant.rounds == main.accountant.rounds
            and np.array_equal(resumed.participation, main.participation)):
        fail(f"faults: a run saved after round {cut} and restored differs "
             f"from the uninterrupted run after round {rounds}")
    say(f"faults: run state saved after round {cut}, restored into a "
        f"new trainer and run to round {rounds}: params, optimizer state, "
        f"history, participation and accountant bitwise those of the "
        f"uninterrupted run; set-up (data, model, trainer) {setup_s:.1f} s, "
        f"the resumed trainer {resume_s:.1f} s")

    hist = main.state.history
    chunk = eng.cohort_chunk
    want = {"cifg_cell_fwd": 0, "cifg_cell_bwd_seq": 0, "dp_sumsq": 0,
            "dp_clip_accumulate": 0}
    for r, rec in enumerate(hist):
        f = fault_fates(fault_generator(fc.seed, r), eng.padded, fc)
        selected = torch.arange(eng.padded) < eng.sel_cohort
        reported = selected & f.reported
        rejected = int((reported & f.corrupt).sum())
        if rec["n_selected"] != eng.sel_cohort or rec["n_reported"] != int(
                reported.sum()) or rec["n_clients"] != rec["n_reported"] - \
                rejected or rec["committed"] != (rec["n_clients"] >= goal):
            fail(f"faults: round {r + 1} record {rec} disagrees with the "
                 f"host's fates ({int(reported.sum())} reported, "
                 f"{rejected} corrupt)")
        live = int(reported.reshape(-1, chunk).any(-1).sum())
        # a live chunk trains as one program: one launch a local batch
        want["cifg_cell_fwd"] += live * n_batches
        want["cifg_cell_bwd_seq"] += live * n_batches
        want["dp_sumsq"] += live
        want["dp_clip_accumulate"] += live * len(tree_leaves(params0))
    for k, v in want.items():
        if launches[k] != v:
            fail(f"faults launched {k} {launches[k]} times, expected {v}")
    committed = sum(r["committed"] for r in hist)
    if main.accountant.rounds != committed:
        fail(f"faults: accountant {main.accountant.rounds} steps, "
             f"{committed} committed rounds")
    if not all(np.isfinite(r["loss"]) for r in hist):
        fail("faults: training losses not finite")
    sigma = dp.noise_multiplier * dp.clip_norm / goal
    if any(r["noise_std"] != np.float32(sigma) for r in hist):
        fail(f"faults: noise std {[r['noise_std'] for r in hist]} is not "
             f"zS/report_goal {sigma:.6e}")
    noise = eng.init_state(params0, seed=9).draws.noise(
        tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32), params0),
        sigma)
    flat = torch.cat([l.reshape(-1) for l in tree_leaves(noise)])
    std = float(flat.std())
    if abs(std / sigma - 1.0) > 0.02:
        fail(f"faults: engine noise std {std:.4e} vs zS/103 {sigma:.4e}")
    rejected = sum(r["n_reported"] - r["n_clients"] for r in hist)
    say(f"faults: gboard-cifg-lstm vocab {cfg.vocab} d {cfg.d_model} H "
        f"{cfg.d_ff} {cfg.compute_dtype}, {n_users} users, target cohort "
        f"{cohort}, FaultConfig({_kwargs(FAULT_CFG)}): "
        f"late_prob {fc.late_prob:.5f}, expected survival "
        f"{fc.expected_survival:.4f}, {eng.sel_cohort} selected a round "
        f"(padded {eng.padded}, chunks of {chunk}), report goal {goal}; "
        f"{rounds} rounds in {train_s:.2f} s = {rounds / train_s:.3f} "
        f"rounds/s; reported {[r['n_reported'] for r in hist]}, accepted "
        f"{[r['n_clients'] for r in hist]} ({rejected} corrupt reports "
        f"rejected by the guard), {committed} of {rounds} committed; "
        f"accountant {main.accountant.rounds} rounds, eps "
        f"{main.accountant.get_epsilon(1e-6):.3f} at delta 1e-6")
    say(f"faults: the counts, the guard's rejections and the verdicts equal "
        f"the fates drawn again on the host; launches {launches} as the "
        f"report masks predict; noise std {std:.5e} over {flat.numel()} "
        f"entries vs zS/103 {sigma:.5e} ({100 * (std / sigma - 1):+.2f}%, "
        f"tol 2%), the history's {hist[0]['noise_std']:.5e}")
    del noise, flat, resumed

    # the profiled fault-on round (~60 s of trace processing) was cut to
    # make room for phase 15: phase 8's and 10's profiled rounds keep the
    # engine's busy share
    busy = None

    # ------------------------------------ aborts: report goal 150 of 152
    t0 = time.perf_counter()
    strict = trainer(faults=FaultConfig(**FAULT_CFG, report_goal=150))
    aborted, n_strict = 0, 3
    for _ in range(n_strict):
        before = tree_map(torch.clone, strict.state.params)
        m_before = tree_map(torch.clone, strict.state.opt_state.momentum)
        rec = strict.run_round()
        if not rec["committed"]:
            aborted += 1
            if not (_same_tree(strict.state.params, before) and _same_tree(
                    strict.state.opt_state.momentum, m_before)):
                fail("faults: an aborted round changed params or momentum")
    n_comm = sum(r["committed"] for r in strict.state.history)
    if aborted == 0 or strict.accountant.rounds != n_comm:
        fail(f"faults: report goal 150 aborted {aborted} of {n_strict} "
             f"rounds, the accountant took {strict.accountant.rounds} steps "
             f"for {n_comm} committed")
    accepted = [r["n_clients"] for r in strict.state.history]
    say(f"faults: report goal 150 of 152: {aborted} of {n_strict} rounds "
        f"aborted (accepted {accepted}), each leaving params and momentum "
        f"bitwise unchanged; the accountant took {strict.accountant.rounds} "
        f"steps; {time.perf_counter() - t0:.1f} s")
    del strict

    # ------------------------------- the CLI: crash, resume, sha256
    # (its first two runs in subprocesses while a fault-on round runs on
    # the card and on the CPU in this process; stopped however it ends)
    t0 = time.perf_counter()
    cli = ["--vocab", str(vocab), "--rounds", "3", "--n-users", "300",
           "--clients-per-round", "40", "--rounds-per-call", "2",
           "--device", str(dev),
           "--fault-dropout", "0.1", "--fault-straggler", "0.2",
           "--fault-corrupt", "0.05", "--fault-seed", "7"]
    code = ("import sys; sys.modules['msgpack'] = None; "
            "from repro_torch.launch.train import main; main(sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(args, out_dir):
        return subprocess.Popen([sys.executable, "-c", code, *cli, *args,
                                 "--out", str(out_dir)], env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    with tempfile.TemporaryDirectory() as tmp:
        full_dir, cut_dir = Path(tmp) / "full", Path(tmp) / "cut"
        procs = [run([], full_dir),
                 run(["--checkpoint-every", "1", "--crash-after", "2"],
                     cut_dir)]
        try:
            _fault_round_vs_cpu(dev, model, ds, params0, cl, n_batches,
                                cohort, fc)
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs) or \
                "simulated crash after round 2" not in logs[1]:
            fail("faults: the training CLI failed:\n" + "\n".join(
                l[-2000:] for l in logs))
        resume = run(["--checkpoint-every", "1", "--resume"], cut_dir)
        log = resume.communicate(timeout=300)[0]
        if resume.returncode or "resumed from" not in log:
            fail(f"faults: the resumed CLI run failed:\n{log[-2000:]}")
        name = "gboard-cifg-lstm_r3.msgpack"
        digests = [_sha256(d / name) for d in (full_dir, cut_dir)]
    if digests[0] != digests[1]:
        fail(f"faults: CLI checkpoints differ: uninterrupted {digests[0]}, "
             f"crashed then resumed {digests[1]}")
    say(f"faults: the training CLI at vocab {vocab} (300 users, 40 a round, "
        f"faults on), 3 rounds uninterrupted and crashed after round 2 then "
        f"resumed, in subprocesses with msgpack made unimportable: final "
        f"checkpoints sha256 {digests[0][:16]}... equal; "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"faults: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "rounds_per_s": rounds / train_s,
            "committed": committed, "busy": busy}


def _fault_round_vs_cpu(dev, model, ds, params0, cl, n_batches, cohort,
                        fc) -> None:
    """Phase 9's fault-on round (z 0), card (kernels) against the CPU
    (plain), on one stream of draws: counts and verdict equal, the change
    within `TOL_ROUND`."""
    import numpy as np
    import torch

    from repro_torch.configs import DPConfig
    from repro_torch.fl.engine import EngineDraws, SimEngine
    from repro_torch.utils.pytree import tree_leaves, tree_map

    t0 = time.perf_counter()
    dp0 = DPConfig(clients_per_round=cohort, noise_multiplier=0.0,
                   clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                   server_momentum=0.9)
    out, side_s = [], []
    for d in (dev, torch.device("cpu")):
        t1 = time.perf_counter()
        e = SimEngine(model, ds.to_device_arrays(), dp0, cl,
                      n_local_batches=n_batches, availability=0.3,
                      fault_config=fc, device=d)
        # draws from one CPU generator: both engines take the same cohorts,
        # example rows, fates and noise
        draws = EngineDraws(torch.Generator().manual_seed(3))
        st, h = e.run(e.init_state(params0, draws=draws), 1)
        out.append((tree_map(lambda l: l.cpu(), st.params), h))
        side_s.append(time.perf_counter() - t1)
    (pc, hc), (pp, hp) = out
    for k in ("n_selected", "n_reported", "n_clients", "committed"):
        if not np.array_equal(hc[k], hp[k]):
            fail(f"faults: card vs CPU {k} {hc[k]} vs {hp[k]}")
    if not hc["committed"][0]:
        fail("faults: the compared round aborted")
    p0 = tree_map(lambda l: l.cpu(), params0)
    dc = torch.cat([(a - b).reshape(-1).float() for a, b in
                    zip(tree_leaves(pc), tree_leaves(p0))])
    dpu = torch.cat([(a - b).reshape(-1).float() for a, b in
                     zip(tree_leaves(pp), tree_leaves(p0))])
    rel = float((dc - dpu).norm() / dpu.norm())
    errs = {"sum": rel,
            "norm": abs(hc["mean_update_norm"][0] / hp["mean_update_norm"][0]
                        - 1),
            "loss": abs(hc["loss"][0] - hp["loss"][0]),
            "frac": abs(hc["frac_clipped"][0] - hp["frac_clipped"][0])}
    for k, v in errs.items():
        if not v <= TOL_ROUND[k]:
            fail(f"faults: card vs CPU round {k} error {v:.3e} > "
                 f"{TOL_ROUND[k]:g}")
    say(f"faults: one fault-on round (z 0), card (kernels) against the CPU "
        f"(plain) on one stream of draws: counts and verdict equal "
        f"({int(hc['n_reported'][0])} reported, {int(hc['n_clients'][0])} "
        f"accepted); parameter change rel L2 {rel:.2e}, norm "
        f"{errs['norm']:.2e}, loss {errs['loss']:.2e}, clipped fraction {errs['frac']:.3f} "
        f"(TOL_ROUND {TOL_ROUND}); {time.perf_counter() - t0:.1f} s, the "
        f"card's round {side_s[0]:.1f} s, the CPU's {side_s[1]:.1f} s (the "
        f"CLI's runs beside it)")


def _rss_mb() -> float:
    """This process's resident set, MB (``VmRSS``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


def phase_fleet(dev, **kw) -> dict:
    """:func:`_phase_fleet` in a temporary directory; the subprocesses it
    starts are stopped however it ends."""
    import tempfile

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            return _phase_fleet(dev, tmp, procs, **kw)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _phase_fleet(dev, tmp: str, procs: list, n_users: int = 4_000_000,
                 base_users: int = 1000, cohort: int = 128,
                 vocab: int = 10_000, rounds: int = 10, per_call: int = 5,
                 parity_rounds: int = 3, sampler_rounds: int = 5) -> dict:
    """The paper's fleet on one card: full-width gboard-cifg-lstm trained
    over n_users through the streamed population backend (the corpus on the
    host behind a PopulationStore, one cohort staged a round) and the
    block-keyed sharded sampler. The store is the Train corpus written by
    the port's corpus builder, opened memory-mapped and replicated to
    n_users. Checks: the streamed backend bitwise the device backend at
    base_users (both samplers; fixed, Poisson and faulty rounds; in-memory
    and mmap stores; run and run_python); the sharded cohorts on the card
    equal to the CPU's at n_users; launches over the counted rounds; the
    corpus bytes on the card equal at base_users and n_users; the training
    CLI over the store, crashed and resumed, sha256-equal."""
    import dataclasses
    import os

    import numpy as np
    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.data.population_store import (InMemoryPopulationStore,
                                                   MmapPopulationStore,
                                                   ReplicatedPopulationStore)
    from repro_torch.fl.engine import EngineDraws, SimEngine
    from repro_torch.fl.faults import FaultConfig
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.reduction import canon_pad
    from repro_torch.fl.round import FederatedTrainer
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.launch import build_corpus
    from repro_torch.models import build
    from repro_torch.utils.pytree import tree_leaves

    t_phase = time.perf_counter()
    cfg = get_config("gboard-cifg-lstm")
    if vocab != cfg.vocab:
        cfg = cfg.with_(vocab=vocab)
    model = build(cfg)
    seq_len, batch, n_batches = 16, 10, 3
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                  server_momentum=0.9)
    cl = ClientConfig(local_epochs=1, batch_size=batch, lr=0.3)
    params0 = model.init(torch.Generator().manual_seed(1), device="cpu")
    rss0 = _rss_mb()
    # ----------------------------------------------------------- the store
    t0 = time.perf_counter()
    path = build_corpus.main(["--out", os.path.join(tmp, "pop"),
                              "--n-users", str(base_users), "--vocab",
                              str(cfg.vocab), "--seq-len", str(seq_len)])
    base = MmapPopulationStore(path)
    ds = FederatedDataset(BigramCorpus(vocab_size=cfg.vocab, seed=0),
                          n_users=base_users, seq_len=seq_len,
                          sentences_per_user=30)
    train_arrays = ds.to_device_arrays()
    if any(not np.array_equal(v, train_arrays[k])
           for k, v in base.device_arrays().items()):
        fail("fleet: the built store is not the Train corpus")
    mem = InMemoryPopulationStore.from_arrays(train_arrays)
    fleet = ReplicatedPopulationStore(base, n_users)
    payload = sum(os.path.getsize(p) for p in path.iterdir())
    vectors = fleet.counts.nbytes + fleet.synthetic.nbytes
    rss1 = _rss_mb()
    say(f"fleet: store of the Train corpus ({base_users} users, E_max "
        f"{base.emax}, seq_len {base.row_len - 1}) written by "
        f"repro_torch.launch.build_corpus, equal to the dataset's "
        f"to_device_arrays(), opened memory-mapped ({payload} bytes on "
        f"disk) and replicated to N = {n_users} users ({vectors} bytes of "
        f"per-user vectors, {vectors / n_users:.0f} bytes a user); process "
        f"RSS {rss0:.0f} MB before, {rss1:.0f} MB after; "
        f"{time.perf_counter() - t0:.1f} s")

    # the training CLI over the store, uninterrupted and crashed after
    # round 1, in subprocesses while the parity runs; resumed after them
    t_cli = time.perf_counter()
    cli = ["--population-store", str(path), "--sampler", "sharded",
           "--rounds", "2", "--clients-per-round", str(cohort), "--vocab",
           str(cfg.vocab), "--device", str(dev)]
    code = ("import sys; sys.modules['msgpack'] = None; "
            "from repro_torch.launch.train import main; main(sys.argv[1:])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    full_dir = Path(tmp) / "full"
    cut_dir = Path(tmp) / "cut"

    def run(args, out_dir):
        p = subprocess.Popen([sys.executable, "-c", code, *cli, *args,
                              "--out", str(out_dir)], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    run([], full_dir)
    run(["--checkpoint-every", "1", "--crash-after", "1"], cut_dir)

    def engine(data, backend, sampler, sampling="fixed", faults=None,
               d=dev, **kw):
        return SimEngine(model, data, dataclasses.replace(dp,
                                                          sampling=sampling),
                         cl, n_local_batches=n_batches, availability=0.3,
                         rounds_per_call=per_call, sampler=sampler,
                         population_backend=backend, fault_config=faults,
                         device=d, **kw)

    # ------------------------------------ parity at base_users, bitwise
    t0 = time.perf_counter()
    fc = FaultConfig(**FAULT_CFG)
    cases = (("fixed", None), ("poisson", None), ("fixed", fc))
    # which store and which entry point each case's streamed run takes:
    # every pairing of {in-memory, mmap} x {run, run_python} occurs
    ways = ((mem, "run"), (base, "run_python"), (base, "run"),
            (mem, "run_python"), (mem, "run"), (base, "run_python"))
    checked, way = [], iter(ways)
    for sampler in ("global", "sharded"):
        for sampling, faults in cases:
            e = engine(train_arrays, "device", sampler, sampling, faults)
            want = e.run(e.init_state(params0, seed=11), parity_rounds)
            store, meth = next(way)
            s = engine(store, "streamed", sampler, sampling, faults)
            got = getattr(s, meth)(s.init_state(params0, seed=11),
                                   parity_rounds)
            (ws, wh), (gs, gh) = want, got
            if not (_same_tree(gs.params, ws.params)
                    and _same_tree(gs.opt_state.momentum,
                                   ws.opt_state.momentum)
                    and torch.equal(gs.last_round, ws.last_round)
                    and torch.equal(gs.participation, ws.participation)
                    and _same_hist(gh, wh)):
                fail(f"fleet: streamed ({type(store).__name__}, {meth}) "
                     f"differs from device, sampler {sampler}, {sampling}"
                     f"{' with faults' if faults else ''}")
            checked.append(f"{sampler}/{sampling}"
                           f"{'+faults' if faults else ''} "
                           f"({'mmap' if store is base else 'in-memory'}, "
                           f"{meth}; clients {wh['n_clients'].tolist()})")
    say(f"fleet: at N = {base_users}, {parity_rounds} rounds from one seed, "
        f"the streamed backend bitwise the device backend (params, momentum,"
        f" last_round, participation, history): " + "; ".join(checked)
        + f"; {time.perf_counter() - t0:.1f} s")

    logs = [p.communicate(timeout=300)[0] for p in procs]
    if any(p.returncode for p in procs) or \
            "simulated crash after round 1" not in logs[1] or \
            "population store:" not in logs[0]:
        fail("fleet: the training CLI failed:\n" + "\n".join(
            l[-2000:] for l in logs))
    resume = run(["--checkpoint-every", "1", "--resume"], cut_dir)

    # ------------------- the sharded cohorts, card against CPU, at N
    t0 = time.perf_counter()
    engines = {"card": engine(fleet, "streamed", "sharded"),
               "cpu": engine(fleet, "streamed", "sharded",
                             d=torch.device("cpu"))}
    states = {k: e.init_state(params0, draws=EngineDraws(
        torch.Generator().manual_seed(3))) for k, e in engines.items()}
    k_sel, cpu = engines["cpu"].sel_cohort, engines["cpu"]
    near = 0
    for r in range(sampler_rounds):
        lr_before = states["cpu"].last_round
        ids = {}
        for k, e in engines.items():
            s = states[k]
            lr, part, c = e._sample_phase(s.draws, s.last_round,
                                          s.participation, r)
            states[k] = s._replace(last_round=lr, participation=part)
            ids[k] = c.ids.cpu()
        if not torch.equal(ids["card"], ids["cpu"]):
            fail(f"fleet: sharded cohort of round {r} differs card vs CPU "
                 f"at N = {n_users} in "
                 f"{int((ids['card'] != ids['cpu']).sum())} slots")
        # near ties, printed beside the result: neighbours of the top k+1
        # scores within 1e-6 (the block draws do not touch the generators,
        # so they can be redrawn)
        score = cpu._sharded_score(states["cpu"].draws, r, lr_before)
        top = torch.topk(score, k_sel + 1).values
        near += int((top[:-1] - top[1:] <= 1e-6).sum())
    if not (torch.equal(states["card"].last_round.cpu(),
                        states["cpu"].last_round)
            and torch.equal(states["card"].participation.cpu(),
                            states["cpu"].participation)):
        fail("fleet: last_round or participation differs card vs CPU")
    say(f"fleet: the sharded sampler at N = {n_users} (padded "
        f"{cpu.n_pad}, {cpu.pop_blocks} blocks), card against CPU on one "
        f"CPU stream of block draws, {sampler_rounds} rounds: cohorts "
        f"equal (ids in order), {near} near ties among the top k+1 scores "
        f"(within 1e-6); "
        f"{time.perf_counter() - t0:.1f} s")
    del engines, states, cpu

    log = resume.communicate(timeout=300)[0]
    if resume.returncode or "resumed from" not in log:
        fail(f"fleet: the resumed CLI run failed:\n{log[-2000:]}")
    name = "gboard-cifg-lstm_r2.msgpack"
    digests = [_sha256(d / name) for d in (full_dir, cut_dir)]
    if digests[0] != digests[1]:
        fail(f"fleet: CLI checkpoints differ: uninterrupted {digests[0]}, "
             f"crashed then resumed {digests[1]}")
    say(f"fleet: the training CLI over the store (--population-store, "
        f"--sampler sharded, cohort {cohort}, vocab {cfg.vocab}), 2 rounds "
        f"uninterrupted and crashed after round 1 then resumed, in "
        f"subprocesses with msgpack made unimportable, beside the parity "
        f"and sampler checks: final checkpoints sha256 {digests[0][:16]}... "
        f"equal; {time.perf_counter() - t_cli:.1f} s from launch to the "
        f"resumed run's end")

    # ------------------------------------- memory with N, and the fleet run
    def trainer(backend):
        return FederatedTrainer(
            model, None, dp, cl, pop=PopulationSim(n_users,
                                                   availability=0.3, seed=0),
            seed=0, n_local_batches=n_batches, backend=backend,
            rounds_per_call=per_call, population_backend="streamed",
            population_store=fleet, sampler="sharded", device=dev,
            params=params0)

    torch.cuda.synchronize()
    mem_at = {}
    for n, data in ((base_users, base), (n_users, fleet)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
        e = engine(data, "streamed", "sharded")
        st = e.init_state(params0, seed=0)
        e.run(st, 1)
        torch.cuda.synchronize()
        mem_at[n] = (torch.cuda.memory_allocated() - m0,
                     e.corpus_device_bytes,
                     torch.cuda.max_memory_allocated() - m0)
        del e, st
    staged = 2 * canon_pad(cohort) * base.emax * base.row_len * 4
    if not mem_at[base_users][1] == mem_at[n_users][1] == staged:
        fail(f"fleet: corpus bytes on the card {mem_at} != 2 x padded x "
             f"E_max x {base.row_len} x 4 = {staged}")
    per_user = (mem_at[n_users][0] - mem_at[base_users][0]) \
        / (n_users - base_users)
    device_corpus = n_users * base.emax * base.row_len * 4
    say(f"fleet: device memory after one round (state, staging, params): "
        f"{mem_at[base_users][0]} bytes at N = {base_users}, "
        f"{mem_at[n_users][0]} at N = {n_users}: {per_user:.2f} bytes a user"
        f" grow with N; the corpus on the card {mem_at[n_users][1]} bytes at"
        f" both N (2 staged cohorts), peak over the round "
        f"{mem_at[n_users][2] / 1e6:.1f} MB; the device backend's corpus at "
        f"N = {n_users} would be {device_corpus / 1e9:.2f} GB (reckoned, not "
        f"allocated)")

    counters = (cell_ops.LAUNCHES, clip_ops.LAUNCHES)
    run_s, out = {}, {}
    for backend in ("engine", "engine_python"):
        tr = trainer(backend)
        torch.cuda.synchronize()
        if backend == "engine":
            for c in counters:
                for k in c:
                    c[k] = 0
        t0 = time.perf_counter()
        tr.train(rounds)
        torch.cuda.synchronize()
        run_s[backend] = time.perf_counter() - t0
        if backend == "engine":
            launches = {**cell_ops.LAUNCHES, **clip_ops.LAUNCHES}
        out[backend] = tr
    a, b = out["engine"], out["engine_python"]
    if not (_same_tree(a.state.params, b.state.params)
            and a.state.history == b.state.history):
        fail("fleet: run and run_python differ")
    hist = a.state.history
    if not all(np.isfinite(r["loss"]) for r in hist) or any(
            r["n_clients"] != cohort for r in hist):
        fail(f"fleet: bad round records {hist[:2]}")
    chunks = rounds * canon_pad(cohort) // a.engine.cohort_chunk
    n_leaves = len(tree_leaves(a.state.params))
    want = {"cifg_cell_fwd": chunks * n_batches,
            "cifg_cell_bwd_seq": chunks * n_batches,
            "dp_sumsq": chunks, "dp_clip_accumulate": chunks * n_leaves}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"fleet launched {k} {launches[k]} times, expected {v}")
    rps = {k: rounds / v for k, v in run_s.items()}
    say(f"fleet: gboard-cifg-lstm vocab {cfg.vocab} d {cfg.d_model} H "
        f"{cfg.d_ff} {cfg.compute_dtype} over N = {n_users} users (streamed,"
        f" sharded sampler), cohort {cohort}, {rounds} rounds through "
        f"FederatedTrainer: run (a read every {per_call} rounds) "
        f"{run_s['engine']:.2f} s = {rps['engine']:.3f} rounds/s, "
        f"run_python (in order, a read every round) "
        f"{run_s['engine_python']:.2f} s = {rps['engine_python']:.3f} "
        f"rounds/s; params and history bitwise equal; losses "
        f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}; launches "
        f"{launches} as predicted; eps "
        f"{a.accountant.get_epsilon(1e-6):.3f} at delta 1e-6 (q "
        f"{a.accountant.q:.2e})")

    # ------------------------------------------- the sample phase alone
    sample_ms = {}
    for sampler in ("global", "sharded"):
        e = a.engine if sampler == "sharded" else engine(fleet, "streamed",
                                                         "global")
        st = e.run_sampler(e.init_state(params0, seed=5), 1)
        t0 = time.perf_counter()
        e.run_sampler(st, sampler_rounds)
        sample_ms[sampler] = (time.perf_counter() - t0) * 1e3 \
            / sampler_rounds
    say(f"fleet: the sample phase alone (run_sampler: selection, population "
        f"vectors, example indices, the ids read, the noise draw) at N = "
        f"{n_users}: global {sample_ms['global']:.2f} ms a round, sharded "
        f"{sample_ms['sharded']:.2f} ms a round")

    # -------------------------------------------- one profiled round
    t0 = time.perf_counter()
    round_dev, round_wall, top = profiled_device_ms(
        lambda: a.train(1), 1, warmup=False, cpu=False)
    busy = None if round_dev is None else 100 * round_dev / round_wall
    say(f"fleet: one streamed round under the profiler (device activity "
        f"only): {_fmt_ms(round_dev)} on the device of {round_wall:.1f} ms, "
        f"device busy {'not measured' if busy is None else f'{busy:.1f}%'}; "
        f"by kernel: " + "; ".join(f"{n} {ms * 1e3:.1f} us x{c:g}"
                                   for n, ms, c in top)
        + f"; {time.perf_counter() - t0:.1f} s with the trace's processing")
    del out, a, b
    say(f"fleet: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "rounds_per_s": rps, "busy": busy,
            "sample_ms": sample_ms, "bytes_per_user": per_user}


# ------------------------------------------------ encdec, vlm, training

# prefill + decode against forward for whisper-small, relative to the
# largest logit: as the hybrid's (float32 sums in another order; bf16
# rounds differently on the two paths over 24 layers)
TOL_ENCDEC_CONSISTENT = TOL_HYBRID_CONSISTENT
# the card (kernels) against the CPU (plain versions), float32, relative to
# the largest logit
TOL_ENCDEC_CPU = 1e-4
# one user_update card against CPU, float32: the loss relative; ‖Δ_card −
# Δ_cpu‖ / ‖Δ_cpu‖; the pre-clip norm relative (the kernels and the plain
# recomputation order their float32 sums differently)
TOL_TRAIN = {"loss": 1e-5, "delta": 1e-4, "norm": 1e-4}
# (arch, layers kept, S, image tokens) of phase 13's card-against-CPU
# user_update: depth cut only as far as the CPU side needs; whisper-small
# whole; chameleon-34b's 1,024 image tokens do not fit a 64-token batch,
# so 32 patch embeddings lead it
TRAIN_FAMILIES = (("granite-3-2b", 2, 64, 0), ("olmoe-1b-7b", 2, 64, 0),
                  ("mamba2-370m", 2, 128, 0), ("zamba2-2.7b", 6, 128, 0),
                  ("whisper-small", None, 64, 0),
                  ("chameleon-34b", 1, 64, 32))
WHISPER_PARAMS = 238_279_680
# phase 13 keeps a bf16 round's four deltas on the card for its bitwise
# check up to this size, else in pinned host memory
KEEP_ON_CARD_BYTES = 20 * 2 ** 30
# the training CLI's chunks in phase 13: 32 clients a round pad to 8
# canonical blocks of 4, each one chunk of 4 (the largest divisor <= 32);
# the CLI draws 3 local batches a client
CLI_CHUNK, CLI_BATCHES = 4, 3
# (arch, S) trained uncut in phase 13, a chunk of 4 clients at B 2 against
# the one-client loop
UNCUT_FAMILIES = (("mamba2-370m", 128), ("whisper-small", 64))


def _attn_sites(cfg) -> int:
    """Flash launches of one forward of ``cfg``'s model."""
    return {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
            "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
            "hybrid": cfg.n_layers // max(cfg.hybrid_attn_every, 1),
            "ssm": 0}.get(cfg.family, 0)


def _mixers(cfg) -> int:
    """SSD scan launches of one forward of ``cfg``'s model."""
    return cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0


def _reset(*counters) -> None:
    for c in counters:
        for k in c:
            c[k] = 0


def phase_encdec(dev) -> dict:
    """whisper-small at its published widths and depth (bf16, random
    weights from a seed): 4 clips of 1,500 frame embeddings and a 64-token
    prompt through ``model.prefill`` (36 flash launches: 12 encoder
    self-attentions at Sq = Sk = 1,500, 12 causal decoder self-attentions,
    12 cross-attentions at Sq 64, Sk 1,500; all on the tensor cores), then
    16 greedy ``decode_step``s (no launch); prefill plus 3 decode steps
    against forward (f32 and bf16); the card against the CPU at full depth
    in f32; timings. Then chameleon-34b at full width, 1 layer, 1,024 image
    embeddings and 64 text tokens, card against CPU in f32. Returns the
    flash launches of the served prefill."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute, with_compute_copies
    from repro_torch.utils.pytree import tree_map, tree_size

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config("whisper-small")
    widths = (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
              cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab,
              cfg.n_audio_frames, cfg.act, cfg.norm, cfg.compute_dtype)
    if widths != (12, 12, 768, 12, 12, 64, 3072, 51865, 1500, "gelu",
                  "layernorm", "bfloat16"):
        fail(f"unexpected whisper-small widths: {widths}")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_params = tree_size(strip_compute(params))
    if n_params != WHISPER_PARAMS:
        fail(f"whisper-small: {n_params} parameters, expected "
             f"{WHISPER_PARAMS}")
    B, F, S0, steps = 4, cfg.n_audio_frames, 64, 16
    rng = np.random.default_rng(21)
    frames = torch.from_numpy(rng.standard_normal(
        (B, F, cfg.d_model)).astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(4, cfg.vocab, (B, S0))).to(dev)
    batch = {"frames": frames, "tokens": prompts}

    def serve():
        last, cache = model.prefill(params, batch, max_len=S0 + steps)
        pre = dict(fa_ops.LAUNCHES)
        toks = []
        for _ in range(steps):
            tok = last[:, :cfg.vocab].argmax(-1)
            toks.append(tok)
            last, cache = model.decode_step(params, tok, cache)
        return pre, torch.stack(toks, 1)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset(fa_ops.LAUNCHES)
    t0 = time.perf_counter()
    pre, new = serve()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_sites = _attn_sites(cfg)
    want = {"flash_attention_fwd": n_sites, "flash_attention_fwd_tc": n_sites}
    if pre != want or dict(fa_ops.LAUNCHES) != want:
        fail(f"whisper-small: the prefill launched {pre} and the decode "
             f"steps left {dict(fa_ops.LAUNCHES)}, expected {want} and none "
             f"in the decode steps")
    launches = pre["flash_attention_fwd"]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab:
        fail(f"whisper-small: generated ids outside [0, {cfg.vocab})")
    say(f"encdec: whisper-small {cfg.n_enc_layers} + {cfg.n_layers} layers, "
        f"d {cfg.d_model}, {cfg.n_heads} x hd {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, bf16: {n_params} parameters; "
        f"prefill of {B} x {F} frames + {S0} tokens and {steps} greedy "
        f"decode steps in {serve_s:.2f} s; flash launches {pre} in the "
        f"prefill ({cfg.n_enc_layers} encoder at Sq = Sk = {F}, "
        f"{cfg.n_layers} causal self, {cfg.n_layers} cross at Sq {S0}, Sk "
        f"{F}; all on the tensor cores), none in the decode "
        f"steps; peak device memory {peak_mb:.0f} MiB; first new tokens "
        f"{new[:, :4].tolist()}")

    # timings, none claimed
    pre_fn = lambda: model.prefill(params, batch, max_len=S0 + steps)  # noqa: E731
    pre_ms = cuda_time_ms(pre_fn, 3, warmup=1)
    pre_dev, _, kernels = profiled_device_ms(pre_fn, 1, top=6)
    last, cache = pre_fn()
    tok = last[:, :cfg.vocab].argmax(-1)
    dec = lambda: model.decode_step(params, tok, cache)  # noqa: E731
    dec_ms = cuda_time_ms(dec, 5, warmup=2)
    dec_dev, _, _ = profiled_device_ms(dec, 3, top=1)
    all_dev, all_wall, _ = profiled_device_ms(serve, 1, warmup=False, top=1,
                                              cpu=False)
    flash_ms = sum(ms for k, ms, _ in kernels if "flash_fwd" in k)
    say(f"encdec: whisper-small prefill {B} x ({F} frames + {S0} tokens) "
        f"{pre_ms:.2f} ms eager, {_fmt_ms(pre_dev)} on the device; decode "
        f"step at B={B} {dec_ms:.2f} ms eager, {_fmt_ms(dec_dev)} on the "
        f"device; device busy "
        f"{'not measured' if all_dev is None else f'{100 * all_dev / all_wall:.1f}%'}"
        f" of a profiled prefill + {steps} steps ({_fmt_ms(all_dev)} of "
        f"{all_wall:.1f} ms); top kernels of a prefill (flash "
        f"{flash_ms * 1e3:.1f} us among them): " + "; ".join(
            f"{k} {ms * 1e3:.1f} us x{n:g}" for k, ms, n in kernels))
    del cache

    # prefill + 3 decode steps against forward, full depth
    n_pre = 48
    toks = prompts[:, :n_pre + 3]
    m32 = build(cfg.with_(compute_dtype="float32"))
    p32 = with_compute_copies(strip_compute(params), "float32",
                              m32.compute_copies)
    for dname, m, p in (("float32", m32, p32), ("bfloat16", model, params)):
        full = m.forward(p, {"frames": frames, "tokens": toks})
        last, cache = m.prefill(p, {"frames": frames,
                                    "tokens": toks[:, :n_pre]},
                                max_len=n_pre + 3)
        outs = [last]
        for t in range(n_pre, n_pre + 3):
            lg, cache = m.decode_step(p, toks[:, t], cache)
            outs.append(lg)
        scale = float(full.float().abs().max())
        errs = [float((o.float() - full[:, n_pre - 1 + j].float()).abs()
                      .max()) / scale for j, o in enumerate(outs)]
        tol = TOL_ENCDEC_CONSISTENT[dname]
        if not all(np.isfinite(errs)) or max(errs) > tol:
            fail(f"whisper-small {dname}: prefill + decode disagree with "
                 f"forward: {errs} (tol {tol:g})")
        say(f"encdec: whisper-small {dname}, full depth, prefill of {n_pre} "
            f"+ 3 decode steps against forward over {n_pre + 3} tokens, "
            f"B={B}: max abs err / max |logit| "
            f"{', '.join(f'{e:.2e}' for e in errs)} (tol {tol:g})")
        del cache

    # the card's kernels against the CPU's plain versions, full depth, f32
    b1 = {"frames": frames[:1], "tokens": prompts[:1]}
    _reset(fa_ops.LAUNCHES)
    lg_dev = m32.forward(p32, b1).cpu()
    if fa_ops.LAUNCHES["flash_attention_fwd"] != n_sites:
        fail(f"whisper-small f32 forward launched {dict(fa_ops.LAUNCHES)}")
    cpu_p = with_compute_copies(tree_map(lambda t: t.cpu(),
                                         strip_compute(params)), "float32",
                                m32.compute_copies)
    t0 = time.perf_counter()
    lg_cpu = m32.forward(cpu_p, {k: v.cpu() for k, v in b1.items()})
    cpu_s = time.perf_counter() - t0
    err = float((lg_dev - lg_cpu).abs().max() / lg_cpu.abs().max())
    if not err <= TOL_ENCDEC_CPU:
        fail(f"whisper-small: card and CPU disagree: {err:.3e} (tol "
             f"{TOL_ENCDEC_CPU:g})")
    say(f"encdec: whisper-small card (flash, f32) against CPU (plain), full "
        f"width and depth, B=1, {F} frames + {S0} tokens: max abs err / max "
        f"|logit| {err:.2e} (tol {TOL_ENCDEC_CPU:g}); the CPU took "
        f"{cpu_s:.1f} s")
    del params, p32, cpu_p, m32
    torch.cuda.empty_cache()

    # chameleon-34b: full width, 1 layer, card against CPU, f32
    cfg = get_config("chameleon-34b")
    widths = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
              cfg.d_ff, cfg.vocab, cfg.n_image_tokens, cfg.tie_embeddings)
    if widths != (8192, 64, 8, 128, 22016, 65536, 1024, False):
        fail(f"unexpected chameleon-34b widths: {widths}")
    cfg = cfg.with_(n_layers=1, compute_dtype="float32")
    model = build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    n_img, n_txt = cfg.n_image_tokens, 64
    img = torch.from_numpy(rng.standard_normal(
        (1, n_img, cfg.d_model)).astype(np.float32) * 0.02)
    toks = torch.from_numpy(rng.integers(4, cfg.vocab, (1, n_img + n_txt)))
    _reset(fa_ops.LAUNCHES)
    lg_dev = model.forward(params, {"tokens": toks.to(dev),
                                    "image_embeds": img.to(dev)}).cpu()
    vlm_launches = dict(fa_ops.LAUNCHES)
    if vlm_launches["flash_attention_fwd"] != cfg.n_layers:
        fail(f"chameleon-34b forward launched {vlm_launches}")
    cpu_p = with_compute_copies(tree_map(lambda t: t.cpu(),
                                         strip_compute(params)), "float32",
                                model.compute_copies)
    n_vlm = tree_size(strip_compute(params))
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lg_cpu = model.forward(cpu_p, {"tokens": toks, "image_embeds": img})
    cpu_s = time.perf_counter() - t0
    del cpu_p
    err = float((lg_dev - lg_cpu).abs().max() / lg_cpu.abs().max())
    if not err <= TOL_ENCDEC_CPU:
        fail(f"chameleon-34b: card and CPU disagree at 1 layer: {err:.3e} "
             f"(tol {TOL_ENCDEC_CPU:g})")
    say(f"vlm: chameleon-34b full width (d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv_heads} heads x hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, untied), 1 layer ({n_vlm} parameters), f32, B=1: "
        f"{n_img} image embeddings + {n_txt} tokens, card (flash launches "
        f"{vlm_launches}) against CPU: max abs err / max |logit| {err:.2e} "
        f"(tol {TOL_ENCDEC_CPU:g}); the CPU took {cpu_s:.1f} s")
    say(f"encdec: phase took {time.perf_counter() - t_phase:.1f} s")
    return {"flash_attention_fwd": launches}


def _family_batches(cfg, B: int, S: int, n_img: int, seed: int) -> dict:
    """One batch (leading n_batches axis of 1) of ``cfg``'s family on the
    CPU: tokens and labels, and the stub inputs (frame or patch
    embeddings)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab, (1, B, S + 1))
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (1, B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = (rng.standard_normal(
            (1, B, n_img, cfg.d_model)) * 0.02).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _tree_rel_diff(a, b) -> float:
    """‖a − b‖ / ‖b‖ over two trees of one structure, leaf by leaf on
    ``b``'s device (no flat copy of a full-width tree)."""
    from repro_torch.utils.pytree import tree_leaves

    num = den = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x = x.detach().to(y.device).float()
        num += float(((x - y.float()) ** 2).sum())
        den += float((y.float() ** 2).sum())
    return (num / den) ** 0.5


def _tree_std(a, b) -> float:
    """The std of every entry of a − b over two trees of one structure."""
    from repro_torch.utils.pytree import tree_leaves

    n = s1 = s2 = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).double()
        n += d.numel()
        s1 += float(d.sum())
        s2 += float((d * d).sum())
    return ((s2 - s1 * s1 / n) / (n - 1)) ** 0.5


def _uncut_chunks(dev, client) -> dict:
    """`UNCUT_FAMILIES` at full width and depth: one ``local_deltas`` of a
    chunk of 4 clients (B 2, one local batch) in f32 against the same four
    through the one-client loop (``client_loss_fn=None``), within
    `TOL_TRAIN`; then both ways in bf16, in turns: eager time, device time,
    peak memory and launches. Returns the launches of the first bf16
    chunk."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.fl.client import local_deltas
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute
    from repro_torch.utils.pytree import tree_size

    counted = {"flash_attention_fwd": 0, "ssd_scan": 0}
    for name, S in UNCUT_FAMILIES:
        t_fam = time.perf_counter()
        cfg = get_config(name).with_(compute_dtype="float32")
        sites, mixers = _attn_sites(cfg), _mixers(cfg)
        per = [_family_batches(cfg, 2, S, 0, seed=200 + u) for u in range(4)]
        chunk = {k: torch.stack([b[k] for b in per]).to(dev) for k in per[0]}
        model = build(cfg)
        params = strip_compute(model.init(
            torch.Generator(device=dev).manual_seed(3), device=dev))
        n_params = tree_size(params)
        dc, lc = local_deltas(model, params, chunk, client)
        dl, ll = local_deltas(model._replace(client_loss_fn=None), params,
                              chunk, client)
        errs = {"loss": max(abs(float(a) - float(b)) / abs(float(b))
                            for a, b in zip(lc, ll)),
                "delta": max(_tree_rel_diff(a, b) for a, b in zip(dc, dl))}
        if not all(errs[k] <= TOL_TRAIN[k] for k in errs):
            fail(f"{name} uncut: the chunk of 4 against the one-client "
                 f"loop {errs} (tol {TOL_TRAIN})")
        del dc, dl, params
        torch.cuda.empty_cache()
        model = build(cfg.with_(compute_dtype="bfloat16"))
        loop = model._replace(client_loss_fn=None)
        params = strip_compute(model.init(
            torch.Generator(device=dev).manual_seed(3), device=dev))
        times = {"chunk": [], "loop": []}
        info = {}
        for turn in range(2):
            for way, m in (("chunk", model), ("loop", loop)):
                _reset(fa_ops.LAUNCHES, ssd_ops.LAUNCHES)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                out = local_deltas(m, params, chunk, client)
                torch.cuda.synchronize()
                times[way].append((time.perf_counter() - t0) * 1e3)
                del out
                info[way] = (torch.cuda.max_memory_allocated() / 2 ** 20,
                             fa_ops.LAUNCHES["flash_attention_fwd"],
                             ssd_ops.LAUNCHES["ssd_scan"])
                if turn == 0 and way == "chunk":
                    counted["flash_attention_fwd"] += info[way][1]
                    counted["ssd_scan"] += info[way][2]
        want = {"chunk": (2 * sites, 2 * mixers),
                "loop": (8 * sites, 8 * mixers)}
        for way, (fa, ssd) in want.items():
            if info[way][1:] != (fa, ssd):
                fail(f"{name} uncut bf16 {way}: launches flash and ssd_scan "
                     f"{info[way][1:]}, expected {(fa, ssd)}")
        dev_ms = {way: profiled_device_ms(
            lambda m=m: local_deltas(m, params, chunk, client), 1,
            warmup=False, top=0, cpu=False)[0]
            for way, m in (("chunk", model), ("loop", loop))}
        say(f"train-family: {name} uncut ({cfg.n_layers} layers, "
            f"{n_params} parameters), 4 clients at B=2 S={S}, one local "
            f"batch: f32 chunk against the one-client loop: loss "
            f"{errs['loss']:.2e}, |dDelta|/|Delta| {errs['delta']:.2e} (tol "
            f"{TOL_TRAIN}); bf16 on {CARD}, in turns: "
            + "; ".join(f"{way} eager {' / '.join(f'{t:.1f}' for t in ts)} "
                        f"ms, device {_fmt_ms(dev_ms[way])}, peak "
                        f"{info[way][0]:.0f} MiB, launches flash "
                        f"{info[way][1]}, ssd_scan {info[way][2]}"
                        for way, ts in times.items())
            + f"; {time.perf_counter() - t_fam:.1f} s in all")
        del params, chunk
        torch.cuda.empty_cache()
    return counted


def phase_families(dev) -> dict:
    """Every family trains on the card at full width (C1): per family one
    ``user_update`` in f32 (the batched chunk program at a width of 1),
    card against CPU, on the same weights and batch (B 2, S 128 for the
    SSM and hybrid families and 64 for the others; depth cut as
    `TRAIN_FAMILIES` says), with the flash and SSD launches of the client
    step exact under remat; the MoE's top-k sets compared first, its bf16
    combine roundings replayed on the CPU within `COMBINE_NEAR`, a bound
    that must catch two planted flash faults (`PlantedFlash`); then one
    DP-FedAvg round of 4 clients on the card in bf16, the 4 trained as one
    chunk, with its launches, its noise std and every client bitwise
    across chunk widths; then `UNCUT_FAMILIES` (`_uncut_chunks`); then
    granite-3-2b at full depth, one ``user_update`` (peak memory, step
    time); then the training CLI on granite-3-2b and zamba2-2.7b reduced,
    2 rounds each, in process. Returns the launches of the main path (the
    bf16 rounds, the uncut chunks, the full-depth step and the CLI
    runs)."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.core.dp_fedavg import finalize_round, server_step
    from repro_torch.core.server_optim import init_state
    from repro_torch.fl.client import (chunk_accumulate, local_deltas,
                                       user_update)
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute
    from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_size,
                                          tree_zeros_like)

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    client = ClientConfig(local_epochs=1, batch_size=2, lr=0.1)
    dp = DPConfig(clients_per_round=4, noise_multiplier=0.3, clip_norm=0.5)
    counters = (fa_ops.LAUNCHES, ssd_ops.LAUNCHES, clip_ops.LAUNCHES)
    main_path = {"flash_attention_fwd": 0, "ssd_scan": 0, "dp_sumsq": 0,
                 "dp_clip_accumulate": 0}
    rows = []
    for name, n_layers, S, n_img in TRAIN_FAMILIES:
        cfg = get_config(name).with_(compute_dtype="float32")
        if n_layers is not None:
            cfg = cfg.with_(n_layers=n_layers)
        model = build(cfg)
        cpu_p = strip_compute(model.init(torch.Generator().manual_seed(0),
                                         device="cpu"))
        card_p = tree_map(lambda t: t.to(dev), cpu_p)
        n_params = tree_size(cpu_p)
        b = _family_batches(cfg, 2, S, n_img, seed=len(rows))
        moe = cfg.family == "moe"
        sites, mixers = _attn_sites(cfg), _mixers(cfg)
        _reset(*counters)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with RouteLog(keep_combine=moe) as card_log:
            dc, nc, fc, lc = user_update(
                model, card_p, {k: v.to(dev) for k, v in b.items()}, client,
                dp)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        got = (fa_ops.LAUNCHES["flash_attention_fwd"],
               ssd_ops.LAUNCHES["ssd_scan"])
        if got != (2 * sites, 2 * mixers):
            fail(f"{name}: one client step launched flash {got[0]} and the "
                 f"SSD scan {got[1]} times, expected {2 * sites} and "
                 f"{2 * mixers} (forward and remat recomputation)")
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(dc)):
            fail(f"{name}: the card's update holds a non-finite value")
        del card_p
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with RouteLog() as cpu_log:
            dh, nh, fh, lh = user_update(model, cpu_p, b, client, dp)
        cpu_s = time.perf_counter() - t0
        note, hold = "", True
        if moe:
            c_sets = torch.stack([c["sets"] for c in card_log.calls])
            h_sets = torch.stack([c["sets"] for c in cpu_log.calls])
            gaps = torch.stack([c["gap"] for c in cpu_log.calls])
            differ = (c_sets != h_sets).any(-1)
            near = gaps <= NEAR_TIE
            if bool((differ & ~near).any()):
                fail(f"{name}: {int((differ & ~near).sum())} token-calls "
                     f"routed to another top-k set on the card with no near "
                     f"tie")
            hold = not bool(differ.any())
            # the bf16 combine weights: a weight whose two float32 values
            # straddle a bf16 rounding boundary moves every gradient; the
            # CPU runs again with the card's roundings, and Δ is held there
            raw = _tree_rel_diff(dc, dh)
            # (a pair on another expert at a near tie leaves Δ unheld)
            with RouteReplay(card_log.calls,
                             bound=COMBINE_NEAR if hold else None) as rep:
                dh, nh, fh, lh = user_update(model, cpu_p, b, client, dp)
            # planted faults: flash's output off by its own float32
            # tolerance, then by the card-against-CPU one, the CPU replaying
            # each run's roundings with the bound off; the bound must catch
            # both
            planted = []
            for tol in (TOL_FLASH["float32"], TOL_ENCDEC_CPU):
                card_p = tree_map(lambda t: t.to(dev), cpu_p)
                with PlantedFlash(tol), RouteLog(keep_combine=True) as log:
                    user_update(model, card_p, {k: v.to(dev) for k, v in
                                                b.items()}, client, dp)
                del card_p
                torch.cuda.empty_cache()
                with RouteReplay(log.calls, bound=None) as bad:
                    user_update(model, cpu_p, b, client, dp)
                planted.append((tol, bad.flips, bad.moved, bad.gap))
            note = (f"; MoE routing over {len(card_log.calls)} router calls "
                    f"(forward and recomputation): {int(differ.sum())} "
                    f"token-calls with another top-k set, "
                    f"{int(near.sum())} near ties (gap <= {NEAR_TIE:g}) of "
                    f"{near.numel()}; {rep.flips} bf16 combine weights "
                    f"rounded the other way (near ties, float32 values "
                    f"within {rep.gap:.2e}): |dDelta|/|Delta| "
                    f"{raw:.2e} before the CPU took the card's roundings, "
                    f"the figures here after; planted faults (flash off by "
                    f"tol + tol|out|): "
                    + ", ".join(f"tol {t:g} flips {n} ({m} on another "
                                f"expert), the others' largest gap {g:.2e}"
                                for t, n, m, g in planted)
                    + f" (bound {COMBINE_NEAR:g})")
            if not all(gap > COMBINE_NEAR or moved
                       for _, _, moved, gap in planted):
                fail(f"{name}: the combine near-tie bound {COMBINE_NEAR:g} "
                     f"does not catch a planted fault{note}")
        del cpu_p
        errs = {"loss": abs(float(lc) - float(lh)) / abs(float(lh)),
                "norm": abs(float(nc) - float(nh)) / float(nh),
                "delta": _tree_rel_diff(dc, dh)}
        del dc, dh
        torch.cuda.empty_cache()
        bad = {k: v for k, v in errs.items() if not v <= TOL_TRAIN[k]}
        if float(fc) != float(fh):
            fail(f"{name}: was_clipped {float(fc)} on the card, {float(fh)} "
                 f"on the CPU")
        if bad and (hold or "delta" not in bad or len(bad) > 1):
            fail(f"{name}: user_update card against CPU out of tolerance: "
                 f"{bad} (tol {TOL_TRAIN}){note}")
        say(f"train-family: {name} ({cfg.family}) full width, "
            f"{cfg.n_layers} layers{'' if n_layers is None else ' (cut)'}, "
            f"{n_params} parameters, f32, B=2 S={S}"
            f"{f', {n_img} image embeddings' if n_img else ''}: user_update "
            f"card against CPU: loss {errs['loss']:.2e}, |dDelta|/|Delta| "
            f"{errs['delta']:.2e}{'' if hold else ' (not held: routing)'}, "
            f"norm {errs['norm']:.2e} (tol {TOL_TRAIN}); was_clipped "
            f"{float(fc):g} both; launches flash {got[0]}, ssd_scan {got[1]}"
            f" (2 x {sites} sites, 2 x {mixers} mixers under remat); card "
            f"{card_s:.2f} s, peak {peak_mb:.0f} MiB; CPU {cpu_s:.1f} s"
            f"{note}")

        # one DP-FedAvg round on the card, bf16: 4 clients as one chunk
        cfg16 = cfg.with_(compute_dtype="bfloat16")
        model = build(cfg16)
        params = strip_compute(model.init(
            torch.Generator(device=dev).manual_seed(1), device=dev))
        per = [_family_batches(cfg16, 2, S, n_img, seed=100 + u)
               for u in range(4)]
        chunk = {k: torch.stack([b[k] for b in per]).to(dev) for k in per[0]}
        _reset(*counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        deltas, losses = local_deltas(model, params, chunk, client)
        total, _ = chunk_accumulate(
            (tree_zeros_like(params, torch.float32),
             torch.zeros((4,), device=dev)), deltas, losses,
            torch.ones((4,), device=dev), dp.clip_norm)
        torch.cuda.synchronize()
        round_s = time.perf_counter() - t0
        # the chunk's deltas wait for the bitwise check below on the card,
        # or in pinned host memory where four of them would crowd the runs
        # that follow (chameleon-34b's four are 28 GB)
        if 16 * tree_size(params) > KEEP_ON_CARD_BYTES:
            def keep(t):
                return torch.empty(t.shape, dtype=t.dtype,
                                   pin_memory=True).copy_(t)
        else:
            def keep(t):
                return t
        four = [([keep(t) for t in tree_leaves(d)], keep(losses[u]))
                for u, d in enumerate(deltas)]
        del deltas
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mean = tree_map(lambda l: l / 4, total)
        noised, stats = finalize_round(
            total, 4, torch.Generator(device=dev).manual_seed(99), dp)
        new_params, opt = server_step(params, init_state(params), noised,
                                      dp)
        torch.cuda.synchronize()
        round_s += time.perf_counter() - t0
        got = {**fa_ops.LAUNCHES, **ssd_ops.LAUNCHES, **clip_ops.LAUNCHES}
        if (got["flash_attention_fwd"], got["ssd_scan"]) != (2 * sites,
                                                             2 * mixers):
            fail(f"{name}: the bf16 round's chunk of 4 launched flash "
                 f"{got['flash_attention_fwd']} and the SSD scan "
                 f"{got['ssd_scan']} times, expected {2 * sites} and "
                 f"{2 * mixers}")
        for k in main_path:
            main_path[k] += got[k]
        sigma = dp.noise_multiplier * dp.clip_norm / 4
        std = _tree_std(noised, mean)
        if abs(std / sigma - 1) > 0.02:
            fail(f"{name}: noise std {std:.4e}, expected {sigma:.4e} within "
                 f"2%")
        if not (bool(torch.isfinite(losses).all()) and all(
                bool(torch.isfinite(t).all())
                for t in tree_leaves(new_params))):
            fail(f"{name}: the bf16 round gave non-finite values")
        del new_params, opt, total, mean, noised
        torch.cuda.empty_cache()
        # every client's Δ and loss bitwise its own at C 1 and at C 2 with
        # the client at the other position
        t0 = time.perf_counter()
        for order in ((0,), (1,), (2,), (3,), (1, 0), (3, 2)):
            ds, ls = local_deltas(model, params, tree_map(
                lambda l: l[list(order)], chunk), client)
            for j, u in enumerate(order):
                if not (torch.equal(ls[j], four[u][1].to(dev)) and all(
                        torch.equal(a, b.to(dev, non_blocking=True))
                        for a, b in zip(tree_leaves(ds[j]), four[u][0]))):
                    fail(f"{name}: client {u}'s bf16 delta or loss in a "
                         f"chunk {order} differs from its bits in the "
                         f"chunk of 4")
            del ds, ls
        say(f"train-family: {name} bf16 DP-FedAvg round on the card, 4 "
            f"clients as one chunk: losses "
            f"{[round(float(x), 3) for x in losses]}, noise std "
            f"{std:.4e} against zS/qN {sigma:.4e}; launches flash "
            f"{got['flash_attention_fwd']} (2 x {sites} sites), ssd_scan "
            f"{got['ssd_scan']} (2 x {mixers} mixers), dp_sumsq "
            f"{got['dp_sumsq']}, dp_clip_accumulate "
            f"{got['dp_clip_accumulate']}; {round_s:.2f} s ({CARD}); every "
            f"client's delta and loss bitwise at C 1 and at C 2 in the "
            f"other position (checked in {time.perf_counter() - t0:.1f} s)")
        del params, four, chunk
        torch.cuda.empty_cache()
        rows.append(name)

    for k, v in _uncut_chunks(dev, client).items():
        main_path[k] += v

    # granite-3-2b at full depth: one user_update on the card
    cfg = get_config("granite-3-2b")
    model = build(cfg)
    params = strip_compute(model.init(
        torch.Generator(device=dev).manual_seed(2), device=dev))
    n_params = tree_size(params)
    b = {k: v.to(dev) for k, v in _family_batches(cfg, 2, 64, 0, 7).items()}
    _reset(*counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    delta, norm, _, loss = user_update(model, params, b, client, dp)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if fa_ops.LAUNCHES["flash_attention_fwd"] != 2 * cfg.n_layers:
        fail(f"granite-3-2b full depth: {dict(fa_ops.LAUNCHES)} flash "
             f"launches, expected {2 * cfg.n_layers}")
    main_path["flash_attention_fwd"] += fa_ops.LAUNCHES["flash_attention_fwd"]
    if not (np.isfinite(float(loss)) and np.isfinite(float(norm))):
        fail("granite-3-2b full depth: non-finite loss or norm")
    del delta
    step = lambda: user_update(model, params, b, client, dp)  # noqa: E731
    eager_ms = cuda_time_ms(step, 2, warmup=0)
    dev_ms, _, top = profiled_device_ms(step, 1, warmup=False, top=4,
                                        cpu=False)
    say(f"train-family: granite-3-2b full depth ({cfg.n_layers} layers, "
        f"{n_params} parameters, bf16 products), one user_update at B=2 "
        f"S=64: first call {step_s:.2f} s, then {eager_ms:.1f} ms eager, "
        f"{_fmt_ms(dev_ms)} on the device; peak device memory {peak_mb:.0f} "
        f"MiB; loss {float(loss):.4f}, norm {float(norm):.3f}; top kernels: "
        + "; ".join(f"{k} {ms:.2f} ms x{n:g}" for k, ms, n in top))
    del params, b
    torch.cuda.empty_cache()

    # the training CLI, reduced, 2 rounds of 32 clients each, on the card:
    # canonical blocks of 4, each trained as one chunk of 4 clients
    for arch in ("granite-3-2b", "zamba2-2.7b"):
        _reset(*counters)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ck = train_main(["--arch", arch, "--reduced", "--rounds", "2",
                             "--n-users", "200", "--clients-per-round", "32",
                             "--out", tmp, "--device", str(dev)])
            size = Path(ck).stat().st_size
            hist = json.loads((Path(tmp) / f"{arch}_r2_history.json")
                              .read_text())
        cli_s = time.perf_counter() - t0
        got = {**fa_ops.LAUNCHES, **ssd_ops.LAUNCHES, **clip_ops.LAUNCHES}
        rcfg = get_config(arch).reduced()
        chunks = sum(-(-int(h["n_clients"]) // CLI_CHUNK) for h in hist)
        want = {"flash_attention_fwd": 2 * _attn_sites(rcfg) * CLI_BATCHES
                * chunks,
                "ssd_scan": 2 * _mixers(rcfg) * CLI_BATCHES * chunks,
                "dp_sumsq": chunks}
        if size < 1000 or any(got[k] != v for k, v in want.items()):
            fail(f"training CLI --arch {arch} --reduced: a {size}-byte "
                 f"checkpoint, launches {got}, expected {want} ({chunks} "
                 f"chunks of {CLI_CHUNK} clients, {CLI_BATCHES} local "
                 f"batches each)")
        for k in main_path:
            main_path[k] += got[k]
        say(f"train-family: CLI --arch {arch} --reduced, 2 rounds of 32 "
            f"clients on the card in {cli_s:.1f} s: a {size}-byte "
            f"checkpoint; {chunks} chunks of {CLI_CHUNK} clients; launches "
            f"{got}, exact per chunk and local batch")
    say(f"train-family: launches on the main path (the bf16 rounds, the "
        f"uncut chunks, the full-depth step, the CLI runs): {main_path}; "
        f"phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return main_path


# (pods, shards) of phase 14's device-backend runs
SHARD_TOPOLOGIES = ((1, 2), (1, 4), (2, 2))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _shard_rank(dev, runs, store: str, vocab: int, cohort: int) -> dict:
    """What one rank of phase 14 runs (and, at (pods, shards) = (1, 1), the
    one-rank runs in the parent): for each ``(pods, shards, spec)`` of
    ``runs`` (every run of a world takes all its ranks) the spec's engine
    at full width from the same seeds, timed, with this rank's launches,
    gathers and population bytes on the device, keyed by ``(pods, shards,
    name)``. Results come back on the host."""
    import dataclasses

    import torch

    from repro_torch.configs import ClientConfig, DPConfig, get_config
    from repro_torch.data.population_store import (MmapPopulationStore,
                                                   ReplicatedPopulationStore)
    from repro_torch.fl.engine import SimEngine
    from repro_torch.fl.faults import FaultConfig
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.models import build
    from repro_torch.utils import spans
    from repro_torch.utils.pytree import tree_map

    if torch.distributed.is_initialized():
        torch.set_num_threads(max(1, (os.cpu_count() or 8)
                                  // torch.distributed.get_world_size()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build(get_config("gboard-cifg-lstm").with_(vocab=vocab))
    params0 = model.init(torch.Generator().manual_seed(1), device="cpu")
    base = MmapPopulationStore(store)
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.8, server_opt="momentum", server_lr=0.5,
                  server_momentum=0.9)
    cl = ClientConfig(local_epochs=1, batch_size=10, lr=0.3)
    counters = (cell_ops.LAUNCHES, clip_ops.LAUNCHES)
    host = lambda t: tree_map(lambda l: l.detach().cpu(), t)  # noqa: E731
    out = {}
    for pods, shards, spec in runs:
        pop = (base if spec["n_users"] == base.n_users
               else ReplicatedPopulationStore(base, spec["n_users"]))
        data = pop.device_arrays() if spec["backend"] == "device" else pop
        e = SimEngine(model, data,
                      dataclasses.replace(dp, sampling=spec["sampling"]),
                      cl, n_local_batches=3,
                      availability=spec["availability"],
                      rounds_per_call=spec["rounds"], num_shards=shards,
                      num_pods=pods, sampler=spec["sampler"],
                      population_backend=spec["backend"],
                      fault_config=(FaultConfig(**FAULT_CFG)
                                    if spec["faults"] else None),
                      device=dev)
        ids = []
        sample = e._sample_phase

        def recorded(*args, sample=sample, ids=ids):
            lr, part, cohort_ = sample(*args)
            ids.append(cohort_.ids.clone())
            return lr, part, cohort_

        e._sample_phase = recorded
        state = e.init_state(params0, seed=11)
        pop_bytes = sum(t.numel() * t.element_size() for t in (
            e.counts, e.synthetic, state.last_round, state.participation)
            + ((e._valid, e._synth_pad) if e.sampler == "sharded" else ()))
        for c in counters:
            for k in c:
                c[k] = 0
        _sync(dev)
        t0 = time.time()
        with spans.recording() as rec:
            state, hist = e.run(state, spec["rounds"])
        _sync(dev)
        t1 = time.time()
        launches = {k: v for c in counters for k, v in c.items()}
        out[(pods, shards, spec["name"])] = dict(
            params=host(state.params), momentum=host(state.opt_state.momentum),
            participation=e.population(state.participation).cpu(),
            last_round=e.population(state.last_round).cpu(), hist=hist,
            ids=[i.cpu() for i in ids], launches=launches, t0=t0, t1=t1,
            gather={"bytes": rec.counts["gather_bytes"],
                    "seconds": sum(g.end_ns - g.start_ns for g in
                                   rec.by_name("engine.gather")) / 1e9},
            pop_bytes=pop_bytes,
            staged=e.corpus_device_bytes, chunk=e.cohort_chunk,
            padded=e.padded)
    return out


def _busy_sampler(dev):
    """Start sampling the card's utilization (nvidia-smi's
    ``utilization.gpu``, every 200 ms) in a thread; ``stop()`` returns the
    (host time, percent) samples. On the CPU: nothing."""
    import threading

    samples = []
    if dev.type != "cuda":
        return lambda: samples
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=utilization.gpu",
         "--format=csv,noheader,nounits", "-i", "0", "-lms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def read():
        for line in proc.stdout:
            try:
                samples.append((time.time(), float(line.strip())))
            except ValueError:
                pass

    th = threading.Thread(target=read, daemon=True)
    th.start()

    def stop():
        proc.kill()
        proc.wait()
        th.join(5)
        return samples

    return stop


def phase_shards(dev, n_users: int = 1000, fleet_users: int = 4_000_000,
                 cohort: int = 128, vocab: int = 10_000, rounds: int = 3,
                 cli_users: int = 300, cli_cohort: int = 40) -> dict:
    """:func:`_phase_shards` in a temporary directory; the subprocesses it
    starts are stopped however it ends."""
    import tempfile

    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            return _phase_shards(dev, tmp, procs, n_users, fleet_users,
                                 cohort, vocab, rounds, cli_users,
                                 cli_cohort)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def _phase_shards(dev, tmp, procs, n_users, fleet_users, cohort, vocab,
                  rounds, cli_users, cli_cohort) -> dict:
    """The cohort sharded over ranks on one card: ranks are processes that
    all share the card on gloo (NCCL refuses two ranks on one device),
    started by `launch.mesh.spawn_ranks` after the kernels are built. Each
    run is held bitwise against the one-rank engine (params, momentum,
    population vectors, history; the fleet's cohort ids round by round),
    with every kernel's launches summed over the ranks equal to the one
    rank's; then the training CLI under torch.distributed.run, 4 ranks
    against 1, uninterrupted and crashed then resumed, sha256-equal."""
    import gc

    import numpy as np
    import torch

    from repro_torch.launch import build_corpus
    from repro_torch.launch.mesh import spawn_ranks

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    store = str(build_corpus.main(["--out", os.path.join(tmp, "pop"),
                                   "--n-users", str(n_users), "--vocab",
                                   str(vocab), "--seq-len", "16"]))
    # the CLI runs: 1 rank, 4 ranks, 4 ranks crashed after round 2; they
    # start after the timed runs, and the resume after them
    def spec(name, **kw):
        s = dict(name=name, backend="device", sampler="global",
                 sampling="fixed", faults=False, availability=0.3,
                 n_users=n_users, rounds=rounds)
        s.update(kw)
        return s

    fixed = spec("device/global/fixed")
    pf = spec("device/global/poisson+faults", sampling="poisson",
              faults=True, availability=1.0)
    fleet = spec("fleet/streamed/sharded", backend="streamed",
                 sampler="sharded", n_users=fleet_users)
    # one spawn a world size: the 4-rank topologies share one
    plan = {2: [(1, 2, fixed)],
            4: [(1, 4, fixed), (1, 4, pf), (2, 2, fixed), (2, 2, fleet)]}
    args = (store, vocab, cohort)
    t0 = time.perf_counter()
    one = {k[2]: v for k, v in _shard_rank(
        dev, [(1, 1, s) for s in (fixed, pf, fleet)], *args).items()}
    # the one rank's fixed rounds: one launch of each cell kernel per chunk
    # and local batch (3), every chunk of a full round live
    for s in (fixed, fleet):
        r = one[s["name"]]
        want = rounds * r["padded"] // r["chunk"] * 3
        got = [r["launches"][k] for k in ("cifg_cell_fwd",
                                          "cifg_cell_bwd_seq")]
        if dev.type == "cuda" and got != [want, want]:
            fail(f"shards: the one-rank {s['name']} run launched the cell "
                 f"kernels {got} times, expected {want} each ({rounds} "
                 f"rounds of {r['padded'] // r['chunk']} chunks x 3 local "
                 f"batches)")
    say(f"shards: one-rank runs in this process (the reference of every "
        f"check): " + "; ".join(
            f"{k} {rounds} rounds in {v['t1'] - v['t0']:.2f} s = "
            f"{rounds / (v['t1'] - v['t0']):.3f} rounds/s, clients "
            f"{v['hist']['n_clients'].tolist()}" for k, v in one.items())
        + f"; {time.perf_counter() - t0:.1f} s")
    kernels = ("cifg_cell_fwd", "cifg_cell_bwd_seq", "dp_sumsq",
               "dp_clip_accumulate")
    total = {k: 0 for k in kernels}
    rates, busy = {}, {}
    for n, runs in plan.items():
        t0 = time.perf_counter()
        stop = _busy_sampler(dev)
        try:
            out = spawn_ranks(_shard_rank, n, (runs, *args), backend="gloo",
                              device=None if dev.type == "cuda" else "cpu",
                              timeout=600)
        finally:
            samples = stop()
        say(f"shards: {n} ranks spawned on gloo, sharing {dev}, for "
            f"{len(runs)} run(s): {time.perf_counter() - t0:.1f} s")
        for pods, shards, s in runs:
            name, want, key = s["name"], one[s["name"]], (pods, shards,
                                                          s["name"])
            for r, res in enumerate(out):
                got = res[key]
                diff = [k for k in ("participation", "last_round")
                        if not torch.equal(got[k], want[k])]
                diff += [k for k in ("params", "momentum")
                         if not _same_tree(got[k], want[k])]
                diff += [] if _same_hist(got["hist"], want["hist"]) \
                    else ["history"]
                diff += [] if all(torch.equal(a, b) for a, b in zip(
                    got["ids"], want["ids"])) else ["cohort ids"]
                if diff:
                    fail(f"shards: {name} at (pods {pods}, shards {shards})"
                         f", rank {r}: {', '.join(diff)} differ from the "
                         f"one-rank run")
            # a rank whose slots are all empty launches nothing (a Poisson
            # round packs its clients into the first slots)
            summed = {k: sum(res[key]["launches"][k] for res in out)
                      for k in kernels}
            missing = [k for k in kernels if summed[k] == 0]
            if missing:
                fail(f"shards: no rank of {name} at ({pods}, {shards}) "
                     f"launched {', '.join(missing)}")
            if summed != {k: want["launches"][k] for k in kernels}:
                fail(f"shards: {name} at ({pods}, {shards}): launches summed "
                     f"over the ranks {summed}, one rank "
                     f"{ {k: want['launches'][k] for k in kernels} }")
            for k in kernels:
                total[k] += summed[k]
            start = min(res[key]["t0"] for res in out)
            end = max(res[key]["t1"] for res in out)
            rates[(pods, shards, name)] = rounds / (end - start)
            window = [u for t, u in samples if start <= t <= end]
            busy[(pods, shards, name)] = (float(np.mean(window)) if window
                                          else None)
            g = [res[key]["gather"] for res in out]
            say(f"shards: {name} at (pods {pods}, shards {shards}), {n} ranks "
                f"on gloo sharing {dev}: bitwise the one-rank run (params, "
                f"momentum, participation, last_round, history, cohort ids "
                f"every round); launches summed over the ranks {summed} = "
                f"the one rank's (cifg_cell_fwd by rank "
                f"{[res[key]['launches']['cifg_cell_fwd'] for res in out]})"
                f"; {rounds} rounds in {end - start:.2f} s = "
                f"{rates[(pods, shards, name)]:.3f} rounds/s (one rank "
                f"{rounds / (want['t1'] - want['t0']):.3f}; the ranks "
                f"time-share one card: no rate here says anything about "
                f"{n} cards); gathers a round a rank {g[0]['bytes'] / rounds:.0f} "
                f"bytes in {1e3 * np.mean([x['seconds'] for x in g]) / rounds:.1f}"
                f" ms (mean over ranks, from this rank's queued work done to "
                f"the gathered copy, waiting on the slowest rank included); "
                f"card busy "
                + (f"{busy[(pods, shards, name)]:.1f}%"
                   if busy[(pods, shards, name)] is not None
                   else "not measured")
                + " (nvidia-smi utilization.gpu, 200 ms samples over the "
                f"run); population on the card a rank {out[0][key]['pop_bytes']} "
                f"bytes (one rank {want['pop_bytes']}), staged corpus a rank "
                f"{out[0][key]['staged']} bytes (one rank {want['staged']})")

    # ----------------------------------------------------------- the CLI
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = ["-m", "repro_torch.launch.train", "--vocab", str(vocab),
           "--n-users", str(cli_users), "--clients-per-round",
           str(cli_cohort), "--rounds", "3", "--rounds-per-call", "2",
           "--device", str(dev), "--checkpoint-every", "1"]
    ranks4 = ["-m", "torch.distributed.run", "--standalone",
              "--nproc-per-node", "4"]
    four = ["--num-shards", "4", "--dist-backend", "gloo"]
    dirs = {k: Path(tmp) / k for k in ("one", "four", "cut")}

    def run(argv):
        p = subprocess.Popen([sys.executable, *argv], env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    runs = {"one": run(cli + ["--out", str(dirs["one"])]),
            "four": run(ranks4 + cli + four + ["--out", str(dirs["four"])]),
            "cut": run(ranks4 + cli + four + ["--crash-after", "2", "--out",
                                              str(dirs["cut"])])}
    logs = {k: p.communicate(timeout=600)[0] for k, p in runs.items()}
    if any(p.returncode for p in runs.values()) or \
            "simulated crash after round 2" not in logs["cut"]:
        fail("shards: the training CLI failed:\n" + "\n".join(
            f"{k}: {v[-2000:]}" for k, v in logs.items()))
    resume = run(ranks4 + cli + four + ["--resume", "--out",
                                        str(dirs["cut"])])
    log = resume.communicate(timeout=600)[0]
    if resume.returncode or "resumed from" not in log:
        fail(f"shards: the resumed CLI run failed:\n{log[-2000:]}")
    if logs["four"].count("checkpoint: ") != 1:
        fail("shards: the 4-rank CLI did not print one checkpoint line")
    digests = {}
    for name in ("gboard-cifg-lstm_r3.msgpack",
                 "gboard-cifg-lstm_r3_history.json"):
        got = {k: _sha256(d / name) for k, d in dirs.items()}
        if len(set(got.values())) != 1:
            fail(f"shards: CLI {name} differs across ranks: {got}")
        digests[name] = got["one"][:16]
    say(f"shards: the training CLI at vocab {vocab} ({cli_users} users, "
        f"{cli_cohort} a round, 3 rounds) under python -m "
        f"torch.distributed.run --standalone --nproc-per-node 4 "
        f"--num-shards 4 --dist-backend gloo, uninterrupted and crashed "
        f"after round 2 then resumed on 4 ranks, against 1 rank: checkpoint "
        f"and history JSON sha256-equal ({digests}); "
        f"{time.perf_counter() - t0:.1f} s")
    say(f"shards: launches on the main path (every rank of every sharded "
        f"run): {total}; phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": total}


# ------------------------------------------------ 15. the production step

# the models phase 15 trains through the (1, 1) step: clients a step
# (cut from train_4k's 256)
PROD_MODELS = (("granite-3-2b", 4), ("mamba2-370m", 4),
               ("gboard-cifg-lstm", 16))
PROD_S = 4096                     # train_4k's sequence
PROD_Z, PROD_CLIP = 0.3, 0.8
# the card against the CPU, at full width, 2 layers: clients × tokens
PROD_CPU = (2, 256)
# the checks of the (1, 1) step against the mesh-free computation and of
# the noise run at 2 layers and this many tokens (the LSTM whole)
PROD_S_BITWISE = 512
# the card against the CPU, and the ranks sharing the card against one
# rank, both at z 0 (so that Δ is the clipped gradients' sum alone): per
# leaf, |Δ − Δ_ref| within this share of the leaf's largest update
# (bfloat16 products rounded at other places: the CPU's are float32
# products rounded once, the model axis splits the contractions)
TOL_PROD = 5e-2
# the loss and the mean update norm, relative: the card against the CPU,
# and the ranks against one rank
TOL_PROD_METRICS = {"cpu": 1e-2, "ranks": 1e-3}
# the noise's std against zS/C, relative
TOL_PROD_NOISE = 2e-2
# the ranks' granite-3-2b: full width at this depth
PROD_RANK_LAYERS = 1
PROD_TOPOLOGIES = {"2x2": ((2, 2), ("data", "model")),
                   "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# the planted fault the ranks' comparison must catch: at (2, 2), the ranks
# of batch row 1 give their clients weight 0 (half the clients lost)
PROD_FAULT = "2x2, row 1 dropped"
# the serving steps: granite-3-2b's prefill at B 1 × 32,768 and decode at
# B 4 against a 32,768-slot cache (prefill_32k and decode_32k cut in batch)
PROD_PREFILL = (1, 32_768)
PROD_DECODE = (4, 32_768, 3)


def _prod_config(name: str, n_layers=None):
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return cfg if n_layers is None else cfg.with_(n_layers=n_layers)


def _prod_batch(cfg, C: int, S: int, seed: int, dev) -> dict:
    import torch

    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (C, S + 1), generator=gen).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _dt_zeros(dparams):
    """float32 zeros in the layout of a DTensor tree, made in place on
    each rank (no full copy)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda d: DTensor.from_local(
        torch.zeros_like(d.to_local(), dtype=torch.float32), d.device_mesh,
        d.placements, run_check=False, shape=d.shape, stride=d.stride()),
        dparams)


def _prod_step(dev, cfg, C: int, S: int, z: float, shape=(1, 1),
               axes=("data", "model"), seed: int = 0, gather: bool = True,
               init_dev=None):
    """One production train step of ``cfg`` over a mesh of the running
    ranks: params from ``seed`` drawn on ``init_dev`` (default the rank's
    device) and moved to the rank's, C clients of S tokens, noise z.
    Returns the metrics, the count, the launches, the step's seconds and
    peak memory, and (``gather``) the new params and momentum whole on the
    rank's device."""
    import gc

    import torch

    from repro_torch.configs import DPConfig, InputShape, MeshConfig
    from repro_torch.core.server_optim import ServerOptState
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build
    from repro_torch.sharding import specs as SP
    from repro_torch.utils.params import strip_compute

    model = build(cfg)
    mcfg = MeshConfig(tuple(shape), tuple(axes))
    mesh = make_production_mesh(multi_pod="pod" in axes, shape=shape,
                                device_type=dev.type)
    pspecs = SP.param_specs(ST.params_shape(model), cfg, mcfg)
    gen = torch.Generator(init_dev or dev).manual_seed(seed)
    p0 = strip_compute(model.init(gen, device=dev))
    params = SP.distribute_params(p0, pspecs, mesh)
    del p0
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    mom = _dt_zeros(params)
    state = ServerOptState(momentum=mom, nu=_dt_zeros(params), count=0)
    step = ST.make_fed_train_step(
        model, DPConfig(clients_per_round=C, noise_multiplier=z,
                        clip_norm=PROD_CLIP), mesh, mcfg, pspecs,
        InputShape("train_4k_cut", S, C, "train"))
    batch = _prod_batch(cfg, C, S, seed + 1, dev)
    counters = (fa_ops.LAUNCHES, ssd_ops.LAUNCHES, cell_ops.LAUNCHES)
    _reset(*counters)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, metrics = step(params, state, batch,
                                  torch.Generator(dev).manual_seed(seed + 2))
    _sync(dev)
    out = {"seconds": time.perf_counter() - t0,
           "peak_gb": (torch.cuda.max_memory_allocated() / 1e9
                       if dev.type == "cuda" else None),
           "launches": {k: v for c in counters for k, v in c.items()},
           "metrics": {k: float(v) for k, v in metrics.items()},
           "count": int(state.count)}
    if gather:
        out["params"] = SP.gather_params(params)
        out["momentum"] = SP.gather_params(state.momentum)
    del params, state, mom
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _tree_to(tree, dev):
    from repro_torch.utils.pytree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


def _prod_rank(dev, plan: dict, ref_path: str) -> dict:
    """What one rank sharing the card runs in phase 15: each topology of
    ``plan`` ({name: (shape, axes, (model, layers, C, S, z))}); rank 0
    holds the params and momentum against the one-rank run saved at
    ``ref_path`` and returns the largest per-leaf errors. Under
    `PROD_FAULT` the ranks of batch row 1 weigh their clients 0."""
    from unittest import mock

    import torch

    from repro_torch.launch import steps as ST

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // 4))
    rank0 = torch.distributed.get_rank() == 0
    ref = torch.load(ref_path, map_location=dev) if rank0 else None
    starts = {}
    clip = ST._clip

    def dropped(ss, clip_S, lr):
        norm, clipped, w = clip(ss, clip_S, lr)
        return norm, clipped, 0 * w

    out = {}
    for name, (shape, axes, (model, layers, C, S, z)) in plan.items():
        t0 = time.perf_counter()
        cfg = _prod_config(model, layers)
        # the mesh is rank-major and ``model`` its last axis
        row = torch.distributed.get_rank() // shape[-1]
        with mock.patch.object(ST, "_clip", dropped if name == PROD_FAULT
                               and row == 1 else clip):
            r = _prod_step(dev, cfg, C, S, z, shape, axes)
        got = {k: r.pop(k) for k in ("params", "momentum")}
        r["run_s"] = time.perf_counter() - t0
        if rank0:
            if (model, layers) not in starts:
                starts[model, layers] = _prod_start(cfg, dev)
            r["worst"] = max(
                _prod_worst(got["params"], ref["params"],
                            starts[model, layers]),
                _prod_worst(got["momentum"], ref["momentum"], None))
        del got
        out[name] = r
    return out


def _prod_close(got, want, start, what: str) -> float:
    """The largest per-leaf |Δ_got − Δ_want| / max|Δ_want|; fails above
    `TOL_PROD`."""
    worst = _prod_worst(got, want, start)
    if worst > TOL_PROD:
        fail(f"production: {what}: per-leaf update error {worst:.3e} above "
             f"{TOL_PROD}")
    return worst


def _prod_worst(got, want, start) -> float:
    """The largest per-leaf |Δ_got − Δ_want| / max|Δ_want|, Δ the change
    from ``start`` (None: the leaves themselves), in float64 on ``want``'s
    device."""
    from repro_torch.utils.pytree import tree_leaves

    worst = 0.0
    for g, w, s in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(start) if start is not None
                       else [None] * len(tree_leaves(want))):
        g, w = g.to(w.device).double(), w.double()
        if s is not None:
            s = s.to(w.device).double()
            g, w = g - s, w - s
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        worst = max(worst, err / scale if scale > 0 else err)
    return worst


def _prod_plain(dev, cfg, C, S, z, seed: int = 0) -> dict:
    """The same step written without a mesh (`steps.fed_train_step_plain`)
    from the same seeds, on one device."""
    import torch

    from repro_torch.configs import DPConfig
    from repro_torch.core.server_optim import init_state
    from repro_torch.launch import steps as ST
    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute

    model = build(cfg)
    p0 = strip_compute(model.init(torch.Generator(dev).manual_seed(seed),
                                  device=dev))
    p, st, m = ST.fed_train_step_plain(
        model, DPConfig(clients_per_round=C, noise_multiplier=z,
                        clip_norm=PROD_CLIP), p0, init_state(p0),
        _prod_batch(cfg, C, S, seed + 1, dev),
        torch.Generator(dev).manual_seed(seed + 2))
    return {"params": p, "momentum": st.momentum,
            "metrics": {k: float(v) for k, v in m.items()}}


def _prod_cut(name: str):
    """The depth of phase 15's checks: 2 layers, the LSTM whole."""
    return None if name == "gboard-cifg-lstm" else 2


def _prod_cpu_side(out_path: str) -> None:
    """The CPU half of phase 15's card-against-CPU check, run in a process
    of its own beside the card's steps: each model at `_prod_cut`'s depth,
    `PROD_CPU` clients × tokens, z 0, from params drawn on the card from
    the same seed as the card's; the new params and the metrics saved to
    ``out_path``."""
    import torch

    from repro_torch.launch.mesh import one_rank

    # the card's steps keep a core for their host dispatch
    torch.set_num_threads(max(1, (os.cpu_count() or 8) - 2))
    Cc, Sc = PROD_CPU
    out = {}
    with one_rank(device="cpu") as cdev:
        for name, _ in PROD_MODELS:
            t0 = time.perf_counter()
            r = _prod_step(cdev, _prod_config(name, _prod_cut(name)), Cc,
                           Sc, 0.0, init_dev=torch.device("cuda"))
            out[name] = {"params": r["params"], "metrics": r["metrics"],
                         "seconds": time.perf_counter() - t0}
    torch.save(out, out_path)


@contextlib.contextmanager
def _in_background(fn, *args):
    """``fn(*args)`` in a spawned process for the span of the block;
    yields the process, stopped on the way out if it still runs."""
    import torch.multiprocessing as mp

    proc = mp.get_context("spawn").Process(target=fn, args=args)
    proc.start()
    try:
        yield proc
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join(30)


def phase_production(dev, layers_full=None, S: int = PROD_S,
                     S_small: int = 64, prefill=PROD_PREFILL,
                     decode=PROD_DECODE) -> dict:
    """15: the production step (`launch.steps`) on DTensor over the
    (data, model) mesh: the (1, 1) train step of granite-3-2b and
    mamba2-370m uncut and the CIFG-LSTM at its published widths, with the
    exact launches of their kernels; bitwise the mesh-free computation; the
    card against the CPU (whose steps run in a process of their own beside
    the card's); the noise's std; the serving steps of granite-3-2b at
    32,768 tokens; and ranks sharing the card on gloo at (2, 2) and
    (2, 1, 2) against one rank at z 0, with a planted fault that the
    comparison must catch. ``layers_full`` cuts the "uncut" models' depth
    for a rehearsal on the CPU. Returns the launches of the main path."""
    import gc
    import tempfile

    import torch

    from repro_torch.launch.mesh import one_rank

    t_phase = t_part = time.perf_counter()
    parts = {}

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches = {"flash_attention_fwd": 0, "ssd_scan": 0,
                "cifg_cell_fwd": 0, "cifg_cell_bwd_seq": 0}
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.ExitStack() as stack:
        cpu_path = os.path.join(tmp, "cpu.pt")
        cpu_side = (stack.enter_context(_in_background(_prod_cpu_side,
                                                       cpu_path))
                    if dev.type == "cuda" else None)
        with one_rank(device=dev.type) as rdev:
            _prod_full_depth(rdev, layers_full, S, launches)
            part("full depth")
            _prod_bitwise(rdev, S)
            part("bitwise and noise")
            card = ({name: _prod_step(rdev, _prod_config(name,
                                                         _prod_cut(name)),
                                      *PROD_CPU, 0.0)
                     for name, _ in PROD_MODELS}
                    if cpu_side is not None else None)
        if cpu_side is not None:
            cpu_side.join(900)
            if cpu_side.exitcode != 0:
                fail(f"production: the CPU side of the card-against-CPU "
                     f"check ended with {cpu_side.exitcode}")
            _prod_card_vs_cpu(dev, card, torch.load(cpu_path))
            del card
        part("card against CPU (the CPU's steps beside the card's)")

    serve = _prod_serve(dev, layers_full, prefill, decode)
    launches["flash_attention_fwd"] += serve["flash_attention_fwd"]
    part("serving")

    launches["flash_attention_fwd"] += _prod_ranks(dev, S_small)
    part("ranks")
    say(f"production: phase {time.perf_counter() - t_phase:.1f} s ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return launches


def _prod_full_depth(rdev, layers_full, S: int, launches: dict) -> None:
    """The (1, 1) step of each model at full depth (``layers_full`` for a
    rehearsal), with its kernels' exact launches, added to ``launches``."""
    for name, C in PROD_MODELS:
        cfg = _prod_config(name, None if name == "gboard-cifg-lstm"
                           else layers_full)
        r = _prod_step(rdev, cfg, C, S, PROD_Z, gather=False)
        got = r["launches"]
        sites, mixers = _attn_sites(cfg), _mixers(cfg)
        want = {"flash_attention_fwd": 2 * sites * C,
                "ssd_scan": 2 * mixers * C,
                "cifg_cell_fwd": C if cfg.family == "lstm" else 0,
                "cifg_cell_bwd_seq": C if cfg.family == "lstm" else 0}
        if rdev.type == "cuda" and {k: got[k] for k in want} != want:
            fail(f"production: {name}'s step launched "
                 f"{ {k: got[k] for k in want} }, expected {want} "
                 f"(flash and the SSD scan: forward and remat "
                 f"recomputation per site per client; the CIFG "
                 f"sequence kernels once each per client)")
        for k in want:
            launches[k] += got[k]
        m = r["metrics"]
        if not all(map(lambda v: v == v and abs(v) < float("inf"),
                       m.values())) or r["count"] != 1:
            fail(f"production: {name}'s step gave {m}, count "
                 f"{r['count']}")
        peak = ("not measured" if r["peak_gb"] is None
                else f"{r['peak_gb']:.1f} GB")
        say(f"production: {name} ({cfg.n_layers} layers, {C} clients "
            f"x {S} tokens, (1, 1) mesh, z {PROD_Z}): step "
            f"{r['seconds']:.2f} s, peak {peak}, "
            f"loss {m['loss']:.4f}, mean update norm "
            f"{m['mean_update_norm']:.4f}, clipped {m['frac_clipped']}, "
            f"launches {want}")


def _prod_bitwise(rdev, S: int) -> None:
    """At `_prod_cut`'s depth: the (1, 1) step bitwise the mesh-free
    computation; granite-3-2b's noise std against zS/C, its params moved
    and its count 1."""
    import torch

    from repro_torch.utils.pytree import tree_leaves

    Sb = min(S, PROD_S_BITWISE)
    for name, C in PROD_MODELS:
        cfg = _prod_config(name, _prod_cut(name))
        r = _prod_step(rdev, cfg, C, Sb, PROD_Z)
        p = _prod_plain(rdev, cfg, C, Sb, PROD_Z)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(r["params"]) + tree_leaves(r["momentum"]),
            tree_leaves(p["params"]) + tree_leaves(p["momentum"])))
        if not same or r["metrics"] != p["metrics"]:
            fail(f"production: {name}'s (1, 1) step is not bitwise the "
                 "mesh-free computation")
        say(f"production: {name} ({cfg.n_layers} layers, {C} clients x "
            f"{Sb}): the (1, 1) step bitwise the mesh-free computation "
            f"(params, momentum, metrics)")
        del p
        if name == "granite-3-2b":
            r0 = _prod_step(rdev, cfg, C, Sb, 0.0)
            diff = torch.cat([(a - b).flatten() for a, b in zip(
                tree_leaves(r["momentum"]), tree_leaves(r0["momentum"]))])
            std, sigma = float(diff.std()), PROD_Z * PROD_CLIP / C
            if abs(std / sigma - 1) > TOL_PROD_NOISE:
                fail(f"production: noise std {std:.5e} vs zS/C "
                     f"{sigma:.5e}")
            moved = max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(r["params"]),
                tree_leaves(_prod_start(cfg, rdev))))
            if moved == 0 or r["count"] != 1:
                fail(f"production: the params did not move ({moved}) "
                     f"or the count is {r['count']}")
            say(f"production: noise std {std:.5e} over {diff.numel()} "
                f"entries vs zS/C {sigma:.5e} "
                f"({100 * (std / sigma - 1):+.2f}%, tol 2%); params "
                f"moved (max |Δ| {moved:.3e}), momentum moved from 0, "
                f"count 1")
            del diff, r0
        del r


def _prod_card_vs_cpu(dev, card: dict, cpu: dict) -> None:
    """The card's steps (``card``) against `_prod_cpu_side`'s (``cpu``):
    per leaf within `TOL_PROD` of the largest update, the metrics within
    ``TOL_PROD_METRICS["cpu"]``; compared on ``dev``."""
    Cc, Sc = PROD_CPU
    for name, _ in PROD_MODELS:
        cfg = _prod_config(name, _prod_cut(name))
        worst = _prod_close(card[name]["params"],
                            _tree_to(cpu[name]["params"], dev),
                            _prod_start(cfg, dev), f"{name} card vs CPU")
        mc, mh = card[name]["metrics"], cpu[name]["metrics"]
        rel = _prod_metrics_close(mc, mh, "cpu", f"{name} card vs CPU")
        say(f"production: {name} ({cfg.n_layers} layers, {Cc} clients x "
            f"{Sc}, z 0) card against CPU: per-leaf update error "
            f"{worst:.2e} (tol {TOL_PROD}), loss {mc['loss']:.5f} vs "
            f"{mh['loss']:.5f}, mean update norm "
            f"{mc['mean_update_norm']:.5f} vs {mh['mean_update_norm']:.5f} "
            f"(relative {rel:.1e}, tol {TOL_PROD_METRICS['cpu']}), clipped "
            f"{mc['frac_clipped']} both; CPU step "
            f"{cpu[name]['seconds']:.1f} s")


def _prod_ranks(dev, S_small: int) -> int:
    """granite-3-2b at full width, `PROD_RANK_LAYERS` deep, 2 clients ×
    ``S_small``, z 0, on 4 gloo ranks sharing the card at each of
    `PROD_TOPOLOGIES` against one rank, and `PROD_FAULT`, which the same
    comparison must catch. Returns the flash launches of the topologies'
    runs, summed over the ranks (the planted fault's not counted)."""
    import tempfile

    import torch

    from repro_torch.launch.mesh import one_rank, spawn_ranks

    layers = PROD_RANK_LAYERS
    run = ("granite-3-2b", layers, 2, S_small, 0.0)
    plan = {k: (shape, axes, run)
            for k, (shape, axes) in PROD_TOPOLOGIES.items()}
    plan[PROD_FAULT] = plan["2x2"]
    t0 = time.perf_counter()
    with one_rank(device=dev.type) as rdev:
        one = _prod_step(rdev, _prod_config("granite-3-2b", layers), 2,
                         S_small, 0.0)
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "one_rank.pt")
        torch.save({k: one.pop(k) for k in ("params", "momentum")}, ref)
        t_ref = time.perf_counter() - t0
        per_rank = spawn_ranks(_prod_rank, 4, (plan, ref), backend="gloo",
                               device=dev.type)
    flash = 0
    for topo in plan:
        got = per_rank[0][topo]
        worst = got["worst"]
        if topo == PROD_FAULT:
            if worst <= TOL_PROD:
                fail(f"production: the planted fault ({topo}) reads "
                     f"{worst:.3e}, within {TOL_PROD}: the ranks' "
                     f"comparison cannot see half the clients lost")
            say(f"production: planted fault ({topo}): per-leaf update "
                f"error against (1, 1) {worst:.2e}, above {TOL_PROD} as "
                f"it must be; {got['run_s']:.1f} s on rank 0")
            continue
        n = sum(r[topo]["launches"]["flash_attention_fwd"]
                for r in per_rank)
        flash += n
        if worst > TOL_PROD:
            fail(f"production: {topo} against (1, 1): per-leaf update "
                 f"error {worst:.3e} above {TOL_PROD}")
        m, m1 = got["metrics"], one["metrics"]
        rel = _prod_metrics_close(m, m1, "ranks", f"{topo} against (1, 1)")
        say(f"production: granite-3-2b ({layers} layer, 2 clients x "
            f"{S_small}, z 0) on 4 gloo ranks sharing the card at {topo}: "
            f"per-leaf update error against (1, 1) {worst:.2e} (tol "
            f"{TOL_PROD}), loss {m['loss']:.5f} vs {m1['loss']:.5f}, mean "
            f"update norm {m['mean_update_norm']:.5f} vs "
            f"{m1['mean_update_norm']:.5f} (relative {rel:.1e}, tol "
            f"{TOL_PROD_METRICS['ranks']}); step {got['seconds']:.2f} s, "
            f"the topology's run {got['run_s']:.1f} s on rank 0; flash "
            f"launches summed over the ranks {n}")
    say(f"production: the ranks' one-rank reference {t_ref:.1f} s, the "
        f"4-rank spawn {time.perf_counter() - t0 - t_ref:.1f} s")
    return flash


def _prod_metrics_close(got: dict, want: dict, which: str, what: str
                        ) -> float:
    """``frac_clipped`` equal, the loss and the mean update norm within
    ``TOL_PROD_METRICS[which]`` relative; returns the larger relative
    error."""
    rel = max(abs(got[k] / want[k] - 1)
              for k in ("loss", "mean_update_norm"))
    if got["frac_clipped"] != want["frac_clipped"] or \
            rel > TOL_PROD_METRICS[which]:
        fail(f"production: {what}: {got} vs {want}")
    return rel


def _prod_start(cfg, dev):
    """The starting params `_prod_step` draws (seed 0, on the card where
    there is one), on ``dev``."""
    import torch

    from repro_torch.models import build
    from repro_torch.utils.params import strip_compute

    at = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    p = strip_compute(build(cfg).init(torch.Generator(at).manual_seed(0),
                                      device=at))
    return _tree_to(p, dev)


def _prod_serve(dev, layers_full, prefill, decode) -> dict:
    """granite-3-2b's prefill and decode steps on the (1, 1) mesh: bitwise
    the unsharded ``prefill`` / ``decode_step`` on a 2,048-token prompt,
    then the prefill at ``prefill`` (B, S) and ``decode`` (B, cache, steps)
    against a cache of random K/V, timed. Returns the prefill's flash
    launches."""
    import gc

    import torch

    from repro_torch.configs import InputShape, MeshConfig
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import make_production_mesh, one_rank
    from repro_torch.models import build
    from repro_torch.models.layers import pad_vocab
    from repro_torch.sharding import specs as SP
    from repro_torch.utils.params import strip_compute, with_compute_copies

    cfg = _prod_config("granite-3-2b", layers_full)
    model = build(cfg)
    mcfg = MeshConfig((1, 1), ("data", "model"))
    out = {}
    with one_rank(device=dev.type) as rdev:
        mesh = make_production_mesh(shape=(1, 1), device_type=dev.type)
        pspecs = SP.param_specs(ST.params_shape(model), cfg, mcfg)
        p0 = strip_compute(model.init(torch.Generator(rdev).manual_seed(3),
                                      device=rdev))
        params = SP.distribute_params(p0, pspecs, mesh)
        # bitwise the unsharded steps at 2,048 tokens
        S0 = min(2048, prefill[1])
        toks = torch.randint(0, cfg.vocab, (1, S0 + 1),
                             generator=torch.Generator().manual_seed(4)
                             ).to(rdev)
        pre = ST.make_prefill_step(model, mesh, mcfg, pspecs,
                                   InputShape("p", S0, 1, "prefill"),
                                   max_len=S0 + 1)
        dec = ST.make_decode_step(model, mesh, mcfg, pspecs,
                                  InputShape("d", S0 + 1, 1, "decode"))
        lg, cache = pre(params, {"tokens": toks[:, :S0]})
        lg2, _ = dec(params, toks[:, S0], cache)
        pc = with_compute_copies(p0, cfg.compute_dtype, model.compute_copies)
        ref, rc = model.prefill(pc, {"tokens": toks[:, :S0]},
                                max_len=S0 + 1)
        ref2, _ = model.decode_step(pc, toks[:, S0], rc)
        if not (torch.equal(lg.full_tensor(), ref)
                and torch.equal(lg2.full_tensor(), ref2)):
            fail("production: the (1, 1) prefill / decode steps are not "
                 "bitwise the unsharded prefill / decode_step")
        say(f"production: granite-3-2b's (1, 1) prefill and decode steps "
            f"bitwise the unsharded ones ({S0}-token prompt)")
        del p0, pc, rc, cache, lg, lg2, ref, ref2
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        B, S = prefill
        toks = torch.randint(0, cfg.vocab, (B, S),
                             generator=torch.Generator().manual_seed(5)
                             ).to(rdev)
        pre = ST.make_prefill_step(model, mesh, mcfg, pspecs,
                                   InputShape("prefill_32k_cut", S, B,
                                              "prefill"))
        pre(params, {"tokens": toks[:, :256]})        # warm
        _reset(fa_ops.LAUNCHES)
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, cache = pre(params, {"tokens": toks})
        _sync(dev)
        pre_s = time.perf_counter() - t0
        out["flash_attention_fwd"] = fa_ops.LAUNCHES["flash_attention_fwd"]
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        if out["flash_attention_fwd"] != cfg.n_layers and dev.type == "cuda":
            fail(f"production: the prefill step launched flash "
                 f"{out['flash_attention_fwd']} times, expected one a layer "
                 f"({cfg.n_layers})")
        lg = logits.full_tensor()
        if tuple(lg.shape) != (B, pad_vocab(cfg.vocab)) or not bool(
                torch.isfinite(lg).all()):
            fail(f"production: prefill logits {tuple(lg.shape)} not finite")
        say(f"production: granite-3-2b prefill step B {B} x {S}: "
            f"{pre_s:.3f} s = {B * S / pre_s:,.0f} tokens/s, flash "
            f"{out['flash_attention_fwd']} launches (one a layer), peak "
            f"{'not measured' if peak is None else f'{peak:.1f} GB'}")
        del logits, cache, lg
        gc.collect()

        Bd, T, steps = decode
        c0 = model.init_cache(Bd, T, device=rdev)
        g = torch.Generator(rdev).manual_seed(6)
        for k in ("k", "v"):
            c0[k].copy_(torch.randn(c0[k].shape, generator=g,
                                    device=rdev).to(c0[k].dtype))
        c0["pos"].fill_(T - steps)
        shape = InputShape("decode_32k_cut", T, Bd, "decode")
        cache = SP.distribute_params(
            c0, SP.cache_specs(c0, cfg, shape, mcfg), mesh)
        del c0
        dec = ST.make_decode_step(model, mesh, mcfg, pspecs, shape)
        tok = torch.randint(0, cfg.vocab, (Bd,),
                            generator=torch.Generator().manual_seed(7)
                            ).to(rdev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _reset(fa_ops.LAUNCHES)
        times = []
        for _ in range(steps - 1):
            _sync(dev)
            t0 = time.perf_counter()
            lg, cache = dec(params, tok, cache)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        dev_ms = None
        if dev.type == "cuda":
            holder = {}

            def one_step():
                holder["out"] = dec(params, tok, cache)

            dev_ms, wall_ms, _ = profiled_device_ms(one_step, 1,
                                                    warmup=False, cpu=False)
            lg = holder["out"][0]
        peak = (torch.cuda.max_memory_allocated() / 1e9
                if dev.type == "cuda" else None)
        if fa_ops.LAUNCHES["flash_attention_fwd"]:
            fail("production: a decode step launched flash")
        lg = lg.full_tensor()
        if tuple(lg.shape) != (Bd, pad_vocab(cfg.vocab)) or not bool(
                torch.isfinite(lg).all()):
            fail(f"production: decode logits {tuple(lg.shape)} not finite")
        say(f"production: granite-3-2b decode step B {Bd} against a "
            f"{T:,}-slot cache: eager {1e3 * min(times):.1f} ms "
            f"(best of {len(times)}), on the device "
            f"{_fmt_ms(dev_ms)} (profiler), peak "
            f"{'not measured' if peak is None else f'{peak:.1f} GB'}")
        del params, cache, lg
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


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
    phase_kernel_bwd(dev)
    bwd = phase_kernel_bwd_seq(dev)
    # the kernels line's row of the sequence backward: a training chunk of
    # 16 clients, its one shape on the main path since the chunk is batched
    chunk_rows = phase_kernel_clients(dev)
    bwd.update({**chunk_rows["bwd"], "max_abs_err": max(
        bwd["max_abs_err"], chunk_rows["bwd"]["max_abs_err"])})
    fwd["max_abs_err"] = max(fwd["max_abs_err"],
                             chunk_rows["fwd"]["max_abs_err"])
    clip_rows = phase_kernel_clip(dev)
    flash = phase_kernel_flash(dev)
    ssd = phase_kernel_ssd(dev)
    serve = phase_serve(dev, fwd)
    train = phase_train(dev)
    step_launches = phase_decode_grad(dev)
    # |R| cut to 2.5·10⁵ (was 5·10⁵) to fit phase 15 in the time limit;
    # the fleet's 10 rounds and the shards' 3 back since the chunk trains
    # as one batched program
    memo = phase_memorize(dev, rs_samples=250_000)
    faults = phase_faults(dev)
    fleet = phase_fleet(dev, rounds=10)
    # phase 14 runs here, beside the other engine paths and before the
    # serving phases fill this process's memory
    shards = phase_shards(dev, rounds=3)
    # phase 15 runs here too, while the serving phases have not yet filled
    # this process's memory: its granite-3-2b step holds ~50 GB of state
    prod = phase_production(dev)
    paths = (train["launches"], memo["launches"], faults["launches"],
             fleet["launches"], shards["launches"])
    bwd["launches"] = sum(p["cifg_cell_bwd_seq"] for p in paths + (prod,))
    fwd["launches"] = serve["launches"] + sum(p["cifg_cell_fwd"]
                                              for p in paths + (prod,))
    say(f"launches of cifg_cell_fwd: serve {serve['launches']}, train "
        f"{train['launches']['cifg_cell_fwd']}, memorize "
        f"{memo['launches']['cifg_cell_fwd']}, faults "
        f"{faults['launches']['cifg_cell_fwd']}, fleet "
        f"{fleet['launches']['cifg_cell_fwd']}, shards "
        f"{shards['launches']['cifg_cell_fwd']} (summed over the ranks), "
        f"production {prod['cifg_cell_fwd']}; of "
        f"cifg_cell_bwd: the sequence form {bwd['launches']} in training, "
        f"memorize, faults, fleet, shards and production, "
        f"the per-step form {step_launches} through decode steps")
    for row in clip_rows:
        row["launches"] = sum(p[row["name"]] for p in paths)
    hybrid = phase_hybrid(dev)
    decoder = phase_decoder(dev)
    encdec = phase_encdec(dev)
    families = phase_families(dev)
    ssd["launches"] = (hybrid["ssd_scan"] + families["ssd_scan"]
                       + prod["ssd_scan"])
    flash["launches"] = (hybrid["flash_attention_fwd"] + decoder
                         + encdec["flash_attention_fwd"]
                         + families["flash_attention_fwd"]
                         + prod["flash_attention_fwd"])
    for row in clip_rows:
        row["launches"] += families[row["name"]]
    say(f"launches of flash_attention_fwd on the main paths: zamba2-2.7b's "
        f"prefill {hybrid['flash_attention_fwd']}, granite-3-2b's and "
        f"olmoe-1b-7b's {decoder}, whisper-small's "
        f"{encdec['flash_attention_fwd']}, training every family "
        f"{families['flash_attention_fwd']}, the production step "
        f"{prod['flash_attention_fwd']}; of ssd_scan: zamba2-2.7b's "
        f"prefill {hybrid['ssd_scan']}, training {families['ssd_scan']}, "
        f"the production step {prod['ssd_scan']}; of "
        f"dp_sumsq and dp_clip_accumulate in training the zoo "
        f"{families['dp_sumsq']} and {families['dp_clip_accumulate']} (the "
        f"card-against-CPU checks not counted)")
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
