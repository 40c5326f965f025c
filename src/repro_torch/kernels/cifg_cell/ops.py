"""The CIFG cell kernel's wrapper and the forward ops built on it.

``cell_fwd`` is the wrapper of the CUDA kernel ``csrc/cifg_cell_fwd.cu``
(which replaces the Pallas ``cell_fwd`` of the reference). It takes the
model's natural layout — zx (B, 3H), h and c (B, H) float32, w_h (H, 3H) in
the compute dtype — with no packing or tile padding: the kernel masks ragged
B and H itself. For tensors on the CPU it computes the plain `cifg_cell_ref`;
for CUDA tensors it launches the kernel or raises.

``LAUNCHES["cifg_cell_fwd"]`` counts kernel launches (only those), so a run
can show that its path went through the kernel.

``cifg_states`` is the forward-only whole-sequence recurrence of the
prefills: it launches the step kernel once per timestep straight into the
preallocated (S, B, H) state stacks. The time-fused backward of the
reference's ``cifg_sequence`` belongs to training and is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cifg_cell.ref import cifg_cell_ref
from repro_torch.utils.numerics import torch_dtype

LAUNCHES = {"cifg_cell_fwd": 0}

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def _kernel():
    lib = build.load("cifg_cell_fwd")
    fn = lib.cifg_cell_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(zx, h, c, w_h, h_out, c_out):
    if h.dim() != 2:
        raise ValueError(f"cell_fwd: h must be (B, H), got {tuple(h.shape)}")
    B, H = h.shape
    shapes = {"zx": (zx, (B, 3 * H)), "c": (c, (B, H)),
              "w_h": (w_h, (H, 3 * H)), "h_out": (h_out, (B, H)),
              "c_out": (c_out, (B, H))}
    for name, (t, shape) in shapes.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(
                f"cell_fwd: expected {name} {shape} for h {(B, H)}, got "
                f"{tuple(t.shape)}")
    for name, t in (("zx", zx), ("h", h), ("c", c), ("h_out", h_out),
                    ("c_out", c_out)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"cell_fwd: {name} must be float32, got {t.dtype}")
    if w_h.dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"cell_fwd: w_h must be bfloat16 or float32 (the "
                        f"compute dtype), got {w_h.dtype}")


def cell_fwd(zx, h, c, w_h, *, h_out=None, c_out=None):
    """One CIFG step → (h', c') float32, the product in ``w_h.dtype``.

    ``h_out`` / ``c_out`` (optional, (B, H) float32, contiguous) receive the
    result in place; otherwise they are allocated."""
    _check(zx, h, c, w_h, h_out, c_out)
    if h.device.type == "cpu":
        hn, cn = cifg_cell_ref(zx, h, c, w_h)
        if h_out is None:
            return hn, cn
        h_out.copy_(hn)
        c_out.copy_(cn)
        return h_out, c_out
    if h.device.type != "cuda":
        raise ValueError(f"cell_fwd: unsupported device {h.device}")
    if h_out is None:
        h_out = torch.empty_like(h)
    if c_out is None:
        c_out = torch.empty_like(c)
    tensors = {"zx": zx, "h": h, "c": c, "w_h": w_h, "h_out": h_out,
               "c_out": c_out}
    for name, t in tensors.items():
        if t.device != h.device:
            raise ValueError(f"cell_fwd: {name} is on {t.device}, h on "
                             f"{h.device}")
        if not t.is_contiguous():
            raise ValueError(f"cell_fwd: {name} must be contiguous")
    B, H = h.shape
    fn = _kernel()
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(zx.data_ptr(), h.data_ptr(), c.data_ptr(), w_h.data_ptr(),
                 int(w_h.dtype == torch.bfloat16), h_out.data_ptr(),
                 c_out.data_ptr(), B, H, stream)
    if err != 0:
        raise RuntimeError(f"cifg_cell_fwd kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, w_h {w_h.dtype})")
    LAUNCHES["cifg_cell_fwd"] += 1
    return h_out, c_out


def _check_sequence(name, zx, h0, c0, w_h):
    if zx.dim() != 3 or h0.dim() != 2 or c0.shape != h0.shape \
            or tuple(zx.shape[1:]) != (h0.shape[0], 3 * h0.shape[1]) \
            or tuple(w_h.shape) != (h0.shape[1], 3 * h0.shape[1]):
        raise ValueError(
            f"{name}: expected zx (S, B, 3H), h0/c0 (B, H), w_h (H, 3H) — "
            f"got zx {tuple(zx.shape)}, h0 {tuple(h0.shape)}, "
            f"c0 {tuple(c0.shape)}, w_h {tuple(w_h.shape)}")


def cifg_step(zx, h, c, w_h, *, compute_dtype=None):
    """Fused CIFG step (forward only). zx (B, 3H), h and c (B, H), w_h
    (H, 3H); ``compute_dtype`` is the product dtype (``None`` =
    ``w_h.dtype``). Returns (h', c') float32. Pass ``w_h`` already in the
    compute dtype to avoid a cast per call."""
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    f32 = torch.float32
    return cell_fwd(zx.to(f32).contiguous(), h.to(f32).contiguous(),
                    c.to(f32).contiguous(), w_h.to(cd).contiguous())


def cifg_states(zx, h0, c0, w_h, *, cell: str = "seq", compute_dtype=None):
    """Forward-only whole-sequence CIFG recurrence → the full state stacks
    (hs, cs), each (S, B, H) float32. zx (S, B, 3H) is time-major.

    ``cell="fused"`` launches the cell kernel once per step (the plain cell
    for CPU tensors), writing each step's state into the stacks;
    ``cell="seq"`` steps the plain cell. The recurrence is causal, so
    ``(hs[t], cs[t])`` of a right-padded run equals the final state of an
    unpadded run of ``t + 1`` steps."""
    _check_sequence("cifg_states", zx, h0, c0, w_h)
    if cell not in ("fused", "seq"):
        raise ValueError(f"cell must be 'fused' or 'seq', got {cell!r}")
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    f32 = torch.float32
    S = zx.shape[0]
    zx = zx.to(f32).contiguous()
    hs = torch.empty((S,) + tuple(h0.shape), dtype=f32, device=h0.device)
    cs = torch.empty_like(hs)
    h, c = h0.to(f32).contiguous(), c0.to(f32).contiguous()
    if cell == "fused":
        w = w_h.to(cd).contiguous()
        for t in range(S):
            h, c = cell_fwd(zx[t], h, c, w, h_out=hs[t], c_out=cs[t])
        return hs, cs
    for t in range(S):
        h, c = cifg_cell_ref(zx[t], h, c, w_h, compute_dtype=cd)
        hs[t], cs[t] = h, c
    return hs, cs
