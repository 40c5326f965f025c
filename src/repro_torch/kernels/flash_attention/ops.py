"""The flash attention kernel's wrapper (the reference's
``flash_attention/ops.py``).

``flash_attention(q, k, v, causal=True, window=0)`` takes the model's GQA
layout — q (B, Sq, H, hd), k and v (B, Sk, KV, hd) — and returns
(B, Sq, H, hd) in q's dtype. The reference's wrapper transposes to
(B, H, S, hd), repeats the KV heads and pads S to 128; the CUDA kernel
(``csrc/flash_attention_fwd.cu``) does none of that: it reads the tensors
through their strides, maps head h to KV head h / (H / KV) and masks at the
true Sk itself. bfloat16 inputs run on the tensor cores (``mma.sync`` on
bf16 tiles, the probabilities rounded to bf16 before PV); float32 inputs on
the CUDA cores, in float32 throughout. Any head dim is taken: the float32
kernel, and above 128 the bf16 kernel's wide route, cut the output's head
dim into slices of at most 128 columns, one block each. For tensors on the CPU the wrapper
computes the plain version (`ref.flash_attention_ref`); for CUDA tensors it
launches the kernel or raises. ``LAUNCHES["flash_attention_fwd"]`` counts
every kernel launch, ``LAUNCHES["flash_attention_fwd_tc"]`` those of the
tensor-core (bf16) form.

On CUDA tensors the result is differentiable: the launch runs inside
`repro_torch.kernels.recompute.RecomputeGrad`, whose backward is the
gradient of the plain version recomputed from the saved q, k and v (the
reference trains through the plain attention, which XLA differentiates;
there is no TPU backward kernel). The backward launches nothing, so the
counters count forward launches only.
"""
from __future__ import annotations

import ctypes

import torch

from functools import partial

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.recompute import RecomputeGrad, by_client

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_fwd_tc": 0}

_DTYPES = (torch.bfloat16, torch.float32)


def _kernel():
    fn = build.load("flash_attention_fwd").flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, heads, "
                             f"hd), got {tuple(t.shape)}")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} must be bfloat16 or "
                            f"float32, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}")
    B, Sq, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    KV = k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got "
                         f"{window}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    clients: int = 1):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), bfloat16 or float32 →
    (B, Sq, H, hd) in q's dtype. ``causal`` masks keys after the query
    (positions from 0 in both), ``window > 0`` keeps the ``window`` newest
    keys up to the query. On CUDA tensors differentiable in q, k and v
    through the plain version's gradient. ``clients``: the batch folds a
    chunk of that many clients' rows, one launch for all, and the plain
    version runs a client at a time (`recompute.by_client`)."""
    _check(q, k, v, window)
    if q.shape[0] % clients:
        raise ValueError(f"flash_attention: {q.shape[0]} batch rows do not "
                         f"fold {clients} clients")
    plain = by_client(partial(flash_attention_ref, causal=causal,
                              window=window), clients)
    if q.device.type == "cpu":
        return plain(q, k, v)
    return RecomputeGrad.apply(partial(_launch, causal=causal, window=window),
                               plain, q, k, v)


def _launch(q, k, v, *, causal: bool, window: int, out=None):
    """One launch of the kernel on checked CUDA tensors, counted. ``out``
    (B, Sq, H, hd) in q's dtype with a contiguous last dim, if given, takes
    the result (`repro_torch.kernels.sanitize` hands in guarded views)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if out is None:
        out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} does not fit q {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous, strides {t.stride()}")
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, out)
                                         for s in t.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), int(q.dtype == torch.bfloat16),
                 B, Sq, Sk, H, KV, hd, int(bool(causal)), int(window),
                 stream)
    if err != 0:   # 1 (invalid value): a shape the kernel does not take
        raise RuntimeError(f"flash_attention_fwd kernel launch failed with "
                           f"CUDA error {err} (B={B}, Sq={Sq}, Sk={Sk}, "
                           f"H={H}, KV={KV}, hd={hd}, {q.dtype}; the kernel "
                           f"takes B, H <= 65535 and ceil(Sq / 64) · "
                           f"ceil(hd / 128) <= 65535)")
    LAUNCHES["flash_attention_fwd"] += 1
    if q.dtype == torch.bfloat16:
        LAUNCHES["flash_attention_fwd_tc"] += 1
    return out
