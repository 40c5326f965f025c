"""The flash attention kernel's wrapper (the reference's
``flash_attention/ops.py``).

``flash_attention(q, k, v, causal=True, window=0)`` takes the model's GQA
layout — q (B, Sq, H, hd), k and v (B, Sk, KV, hd) — and returns
(B, Sq, H, hd) in q's dtype. The reference's wrapper transposes to
(B, H, S, hd), repeats the KV heads and pads S to 128; the CUDA kernel
(``csrc/flash_attention_fwd.cu``) does none of that: it reads the tensors
through their strides, maps head h to KV head h / (H / KV) and masks at the
true Sk itself. For tensors on the CPU the wrapper computes the plain
version (`ref.flash_attention_ref`); for CUDA tensors it launches the kernel
or raises. ``LAUNCHES["flash_attention_fwd"]`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

LAUNCHES = {"flash_attention_fwd": 0}

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


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), bfloat16 or float32 →
    (B, Sq, H, hd) in q's dtype. ``causal`` masks keys after the query
    (positions from 0 in both), ``window > 0`` keeps the ``window`` newest
    keys up to the query."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous, strides {t.stride()}")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
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
                           f"takes hd <= 128 and B, H <= 65535)")
    LAUNCHES["flash_attention_fwd"] += 1
    return out
