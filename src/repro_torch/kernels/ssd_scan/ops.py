"""The SSD scan kernel's wrapper (the reference's ``ssd_scan/ops.py``).

``ssd_scan(x, dt, Bm, Cm, A)`` computes the Mamba-2 chunked scan from a zero
state: ``y`` (B,S,H,p) and the final state (B,H,p,N), both float32. Like the
reference it casts every input to float32 and pads S to a multiple of
``CHUNK`` with dt = 0, which makes the padding an identity step of the
recurrence. For tensors on the CPU it computes the plain chunked form
(`ref.ssd_chunked`); for CUDA tensors it launches ``csrc/ssd_scan.cu`` or
raises. ``LAUNCHES["ssd_scan"]`` counts kernel launches only.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan.ref import CHUNK, ssd_chunked

LAUNCHES = {"ssd_scan": 0}


def _kernel():
    fn = build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, Bm, Cm, A):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,p), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, p = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (Bsz, S, H), "Bm": (Bsz, S, N), "Cm": (Bsz, S, N),
            "A": (H,)}
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: expected {name} {want[name]} for x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if not t.is_floating_point():
            raise TypeError(f"ssd_scan: {name} must be floating point, got "
                            f"{t.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return Bsz, S, H, p, N


def ssd_scan(x, dt, Bm, Cm, A):
    """x: (B,S,H,p); dt: (B,S,H); Bm, Cm: (B,S,N); A: (H,) negative.
    Returns (y (B,S,H,p) float32, final state (B,H,p,N) float32)."""
    Bsz, S, H, p, N = _check(x, dt, Bm, Cm, A)
    pad = (-S) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))    # dt = 0: identity on the padding
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    x, dt, Bm, Cm, A = (t.float().contiguous() for t in (x, dt, Bm, Cm, A))
    if x.device.type == "cpu":
        h0 = torch.zeros((Bsz, H, p, N), dtype=torch.float32)
        y, state = ssd_chunked(x, dt, Bm, Cm, A, h0)
        return y[:, :S], state
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, p, N), dtype=torch.float32, device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz,
                 x.shape[1], H, p, N, stream)
    if err != 0:   # 1 (invalid value): a shape the kernel does not take
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err} (B={Bsz}, S={x.shape[1]}, H={H}, p={p}, "
                           f"N={N}; the kernel takes p, N <= 128 and B <= "
                           f"65535)")
    LAUNCHES["ssd_scan"] += 1
    return (y[:, :S] if pad else y), state
