"""Race and bounds checks of the CIFG kernels, of flash attention and of
the SSD scan at the shapes their paths give them.

Launches ``cifg_cell_fwd`` (``cell_seq_fwd``) at the serving decode tick
(B 256, S 1), the training client batch (B 10, S 16), the admission prefill
(B 1, S 16), the Random-Sampling chunk of the Secret Sharer (B 27,648,
S 5) and its beam search (B 5, S 2–4), bf16 and f32, and
``cifg_cell_bwd_seq`` at the training shape, all at H 256; both again with
a client axis, at a training chunk of 16 clients and at a chunk with more
clusters than the card holds at once (``ops.max_active_clusters``: a launch
in at least two waves), each client with its own w_h, the guard after the
last client's outputs; and
``flash_attention_fwd`` at whisper-small's two shapes that no other path
gives it, in bf16 (the tensor cores) and f32: the encoder's bidirectional
self-attention over 1,500 frames (the last K tile holds 28 of 64 rows) and
the cross-attention of 64 decoder tokens against them (Sq ≪ Sk); and
``ssd_scan`` (its three CUDA kernels, with their scratch) at a training
chunk of 4 clients × B 2 folded into the batch at mamba2-370m's and
zamba2-2.7b's widths and on the wide route (p and N above 128), each with
the shared A (a_stride 0) and one A per batch row, bf16 and f32 inputs.
Each output stack is a view into a larger buffer whose tail is filled with a NaN
pattern; after every launch the tail must still hold it (a write past the
output), and every launch must give bitwise the first one's result (a race
between threads or cluster peers shows as a difference).

    python -m repro_torch.kernels.sanitize --repeats 20
    compute-sanitizer --tool racecheck python -m repro_torch.kernels.sanitize
    compute-sanitizer --tool memcheck python -m repro_torch.kernels.sanitize

Needs a CUDA GPU; prints one line per shape and exits non-zero on a
difference.
"""
from __future__ import annotations

import argparse
import sys

import torch

FWD_SHAPES = (("decode", 256, 1), ("train", 10, 16), ("prefill", 1, 16),
              ("rs", 27648, 5), ("beam", 5, 2), ("beam", 5, 3),
              ("beam", 5, 4))
BWD_SHAPES = (("train", 10, 16),)
CHUNK_SHAPE = (10, 16, 16)      # a training chunk: B, S, clients
# (what, B, Sq, Sk, heads, hd), bidirectional
FLASH_SHAPES = (("whisper encoder", 4, 1500, 1500, 12, 64),
                ("whisper cross-attention", 4, 64, 1500, 12, 64))
# (what, B, S, H, p, N) of the SSD scan: 4 clients × B 2 folded
SSD_SHAPES = (("mamba2-370m chunk", 8, 128, 32, 64, 128),
              ("zamba2-2.7b chunk", 8, 128, 80, 64, 64),
              ("wide route", 8, 256, 4, 256, 192))
GUARD = 4096                    # float32 words after each output
_PATTERN = 0x7FC0DEAD           # a NaN no kernel writes


def _randn(gen, dev, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(dev)


def _guarded(shape, dev, dtype=torch.float32):
    """(view of ``shape`` in ``dtype``, the whole float32 buffer) with a
    patterned tail after the view's bytes."""
    n = 1
    for d in shape:
        n *= d
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    buf = torch.full((-(-nbytes // 4) + GUARD,), _PATTERN, dtype=torch.int32,
                     device=dev).view(torch.float32)
    return buf.view(torch.uint8)[:nbytes].view(dtype).view(shape), buf


def _tail_intact(buf) -> bool:
    return bool((buf[-GUARD:].view(torch.int32) == _PATTERN).all())


def check_fwd(S: int, B: int, H: int, dtype, repeats: int, dev,
              C: int = 0) -> str:
    """``C`` > 0: a chunk of C clients (a leading client axis), each client
    with its own w_h."""
    from repro_torch.kernels.cifg_cell import cell_seq_fwd

    gen = torch.Generator().manual_seed(S * 100_003 + B + C)
    lead = (C,) if C else ()
    zx = _randn(gen, dev, *lead, S, B, 3 * H)
    h0 = _randn(gen, dev, *lead, B, H, scale=0.3)
    c0 = _randn(gen, dev, *lead, B, H, scale=0.3)
    w = _randn(gen, dev, *lead, H, 3 * H, scale=H ** -0.5).to(dtype)
    first = None
    for i in range(repeats):
        hs, hbuf = _guarded(lead + (S, B, H), dev)
        cs, cbuf = _guarded(lead + (S, B, H), dev)
        cell_seq_fwd(zx, h0, c0, w, hs=hs, cs=cs)
        torch.cuda.synchronize()
        if not (_tail_intact(hbuf) and _tail_intact(cbuf)):
            return f"a launch wrote past its output (launch {i})"
        if first is None:
            first = (hs.clone(), cs.clone())
        elif not (torch.equal(hs, first[0]) and torch.equal(cs, first[1])):
            return f"launch {i} differs from launch 0"
    return ""


def check_bwd(S: int, B: int, H: int, repeats: int, dev, C: int = 0) -> str:
    """The sequence backward's entry point called with guarded outputs;
    ``C`` > 0 as in `check_fwd`."""
    from repro_torch.kernels.cifg_cell import ops

    gen = torch.Generator().manual_seed(S * 7 + B + C)
    lead = (C,) if C else ()
    args = (_randn(gen, dev, *lead, S, B, 3 * H),
            _randn(gen, dev, *lead, S, B, H, scale=0.3),
            _randn(gen, dev, *lead, B, H, scale=0.3),
            _randn(gen, dev, *lead, S, B, H, scale=0.1),
            _randn(gen, dev, *lead, B, H, scale=0.1),
            _randn(gen, dev, *lead, B, H, scale=0.1),
            _randn(gen, dev, *lead, H, 3 * H, scale=H ** -0.5))
    fn = ops._kernel("cifg_cell_bwd_seq")
    first = None
    for i in range(repeats):
        dz, zbuf = _guarded(lead + (S, B, 3 * H), dev)
        dh0, hbuf = _guarded(lead + (B, H), dev)
        dc0, cbuf = _guarded(lead + (B, H), dev)
        err = fn(*(a.data_ptr() for a in args), dz.data_ptr(),
                 dh0.data_ptr(), dc0.data_ptr(), max(C, 1), S, B, H,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            return f"launch {i} failed with CUDA error {err}"
        if not all(_tail_intact(b) for b in (zbuf, hbuf, cbuf)):
            return f"a launch wrote past its output (launch {i})"
        out = (dz, dh0, dc0)
        if i == 0:
            ref = ops.cell_bwd_seq(*args)
            if not all(torch.equal(a, b) for a, b in zip(out, ref)):
                return "the guarded launch differs from the wrapper's"
        if first is None:
            first = [t.clone() for t in out]
        elif not all(torch.equal(a, b) for a, b in zip(out, first)):
            return f"launch {i} differs from launch 0"
    return ""


def chunk_sizes(B: int, H: int, dtype) -> dict:
    """The clients of a training chunk, and of a chunk that needs more than
    one wave of clusters, for each kernel: name → (C, clusters the card
    holds at once)."""
    from repro_torch.kernels.cifg_cell import ops

    tiles = -(-B // 16)
    out = {}
    for name in ("cifg_cell_fwd", "cifg_cell_bwd_seq"):
        most = ops.max_active_clusters(name, B, H, dtype)
        out[name] = (most // tiles + 1, most)
    return out


def check_flash(B: int, Sq: int, Sk: int, H: int, hd: int, dtype,
                repeats: int, dev) -> str:
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(Sq * 31 + Sk)
    q = _randn(gen, dev, B, Sq, H, hd).to(dtype)
    k = _randn(gen, dev, B, Sk, H, hd).to(dtype)
    v = _randn(gen, dev, B, Sk, H, hd).to(dtype)
    first = None
    for i in range(repeats):
        out, buf = _guarded((B, Sq, H, hd), dev, dtype)
        ops._launch(q, k, v, causal=False, window=0, out=out)
        torch.cuda.synchronize()
        if not _tail_intact(buf):
            return f"a launch wrote past its output (launch {i})"
        if first is None:
            first = out.clone()
        elif not torch.equal(out, first):
            return f"launch {i} differs from launch 0"
    return ""


def check_ssd(B: int, S: int, H: int, P: int, N: int, dtype, per_row: bool,
              repeats: int, dev) -> str:
    """The scan's entry point called with guarded outputs and scratch (y,
    the final state, the chunk states, the chunk decays); ``per_row``: A
    (B, H), one row each (a_stride H), else (H,) (a_stride 0)."""
    from repro_torch.kernels.ssd_scan import ops

    gen = torch.Generator().manual_seed(S * 13 + H + P + N + per_row)
    x = _randn(gen, dev, B, S, H, P).to(dtype)
    dt = torch.nn.functional.softplus(_randn(gen, dev, B, S, H)) * 0.1
    Bm = _randn(gen, dev, B, S, N).to(dtype)
    Cm = _randn(gen, dev, B, S, N).to(dtype)
    A = -torch.exp(_randn(gen, dev, *((B, H) if per_row else (H,))))
    fn = ops._kernel()
    first = None
    for i in range(repeats):
        bufs = [_guarded(shape, dev) for shape in (
            (B, S, H, P), (B, H, P, N), (B, S // 128, H, P, N),
            (B, S // 128, H))]
        y, state, chunk_states, decay = (v for v, _ in bufs)
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), y.data_ptr(), state.data_ptr(),
                 chunk_states.data_ptr(), decay.data_ptr(),
                 int(dtype == torch.bfloat16), B, S, H, P, N,
                 H if per_row else 0, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        if err:
            return f"launch {i} failed with CUDA error {err}"
        if not all(_tail_intact(b) for _, b in bufs):
            return f"a launch wrote past its output (launch {i})"
        if i == 0:
            ref = ops.ssd_scan(x, dt, Bm, Cm, A)
            if not (torch.equal(y, ref[0]) and torch.equal(state, ref[1])):
                return "the guarded launch differs from the wrapper's"
        if first is None:
            first = (y.clone(), state.clone())
        elif not (torch.equal(y, first[0]) and torch.equal(state, first[1])):
            return f"launch {i} differs from launch 0"
    return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2,
                    help="launches per shape (each held bitwise to the "
                         "first)")
    ap.add_argument("--hidden", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sanitize: needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    bad = 0
    H = args.hidden
    for dtype in (torch.bfloat16, torch.float32):
        for what, B, S in FWD_SHAPES:
            err = check_fwd(S, B, H, dtype, args.repeats, dev)
            bad += bool(err)
            print(f"sanitize: cifg_cell_fwd {what} B={B} S={S} H={H} "
                  f"{str(dtype).split('.')[-1]}, {args.repeats} launches: "
                  f"{err or 'tails intact, bitwise repeatable'}", flush=True)
    for what, B, S in BWD_SHAPES:
        err = check_bwd(S, B, H, args.repeats, dev)
        bad += bool(err)
        print(f"sanitize: cifg_cell_bwd_seq {what} B={B} S={S} H={H}, "
              f"{args.repeats} launches: "
              f"{err or 'tails intact, bitwise repeatable'}", flush=True)
    B, S, C = CHUNK_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        waves = chunk_sizes(B, H, dtype)
        for name, check in (("cifg_cell_fwd", check_fwd),
                            ("cifg_cell_bwd_seq", check_bwd)):
            if name == "cifg_cell_bwd_seq" and dtype != torch.float32:
                continue
            big, most = waves[name]
            for n in sorted({C, big}):
                if name == "cifg_cell_fwd":
                    err = check(S, B, H, dtype, args.repeats, dev, C=n)
                else:
                    err = check(S, B, H, args.repeats, dev, C=n)
                bad += bool(err)
                print(f"sanitize: {name} chunk of {n} clients B={B} S={S} "
                      f"H={H} {str(dtype).split('.')[-1]} ({n * -(-B // 16)} "
                      f"clusters, {most} at once: "
                      f"{-(-n * -(-B // 16) // most)} wave(s)), "
                      f"{args.repeats} launches: "
                      f"{err or 'tails intact, bitwise repeatable'}",
                      flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for what, B, Sq, Sk, nh, hd in FLASH_SHAPES:
            err = check_flash(B, Sq, Sk, nh, hd, dtype, args.repeats, dev)
            bad += bool(err)
            print(f"sanitize: flash_attention_fwd {what} B={B} Sq={Sq} "
                  f"Sk={Sk} H={nh} hd={hd} bidirectional "
                  f"{str(dtype).split('.')[-1]}, {args.repeats} launches: "
                  f"{err or 'tail intact, bitwise repeatable'}", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for what, B, S, nh, P, N in SSD_SHAPES:
            for per_row in (False, True):
                err = check_ssd(B, S, nh, P, N, dtype, per_row, args.repeats,
                                dev)
                bad += bool(err)
                print(f"sanitize: ssd_scan {what} B={B} S={S} H={nh} p={P} "
                      f"N={N} {str(dtype).split('.')[-1]} inputs, "
                      f"{'one A per row' if per_row else 'shared A'}, "
                      f"{args.repeats} launches: "
                      f"{err or 'tails intact, bitwise repeatable'}",
                      flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
