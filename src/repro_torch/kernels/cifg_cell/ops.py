"""The CIFG cell kernels' wrappers and the ops built on them.

``cell_fwd`` and ``cell_bwd`` wrap the CUDA kernels ``csrc/cifg_cell_fwd.cu``
and ``csrc/cifg_cell_bwd.cu`` (which replace the Pallas ``cell_fwd`` and
``cell_bwd`` of the reference). They take the model's natural layout — zx
(B, 3H), h and c (B, H) float32, w_h (H, 3H) in the compute dtype — with no
packing or tile padding: the kernels mask ragged B and H themselves. For
tensors on the CPU a wrapper computes the plain version (`ref.py`); for CUDA
tensors it launches its kernel or raises.

``LAUNCHES[name]`` counts kernel launches (only those), so a run can show
that its path went through the kernels.

* ``cifg_step`` — one step with a custom backward: the forward kernel, and
  ``cell_bwd`` as its gradient (the reference's ``_cifg_step`` custom VJP).
  Differentiating through ``decode_step`` reaches it.
* ``cifg_sequence`` — the whole recurrence with the reference's time-fused
  backward (``_cifg_sequence_fwd`` / ``_cifg_sequence_bwd``): the forward
  launches the cell kernel once per step (``cell="fused"``) or steps the
  plain cell (``"seq"``); the backward recomputes the gates in one product
  over all steps, runs one ``dz @ w_hᵀ`` per step in reverse and forms
  ``dw_h`` in one product. That backward is plain PyTorch, as it is jnp in
  the reference; training's forward and backward both go through it.
* ``cifg_states`` — the forward-only recurrence of the prefills, writing
  each step's state straight into preallocated (S, B, H) stacks.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cifg_cell.ref import cell_bwd_ref, cifg_cell_ref
from repro_torch.utils.numerics import round_to, torch_dtype

LAUNCHES = {"cifg_cell_fwd": 0, "cifg_cell_bwd": 0}

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)


def _kernel(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"cifg_cell_fwd": [p, p, p, p, i, p, p, i, i, p],
                       "cifg_cell_bwd": [p, p, i, p, p, p, p, p, p, p, p, i,
                                         i, p]}[name]
        fn.restype = ctypes.c_int
    return fn


def _on_card(name: str, tensors: dict, device) -> None:
    """Raise unless every tensor is contiguous and on ``device``."""
    for tname, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, h on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _check(name, zx, h, c, w_h, states=None):
    """Shapes and dtypes: zx (B, 3H), h and c (B, H) and the extra (B, H)
    ``states`` (outputs or cotangents; ``None`` entries skipped) float32,
    w_h (H, 3H) bfloat16 or float32."""
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be (B, H), got {tuple(h.shape)}")
    B, H = h.shape
    named = {"zx": zx, "h": h, "c": c, **(states or {})}
    shapes = {"zx": (B, 3 * H), "w_h": (H, 3 * H)}
    for tname, t in {**named, "w_h": w_h}.items():
        if t is not None and tuple(t.shape) != shapes.get(tname, (B, H)):
            raise ValueError(
                f"{name}: expected {tname} {shapes.get(tname, (B, H))} for h "
                f"{(B, H)}, got {tuple(t.shape)}")
    for tname, t in named.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if w_h.dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"{name}: w_h must be bfloat16 or float32 (the "
                        f"compute dtype), got {w_h.dtype}")


def cell_fwd(zx, h, c, w_h, *, h_out=None, c_out=None):
    """One CIFG step → (h', c') float32, the product in ``w_h.dtype``.

    ``h_out`` / ``c_out`` (optional, (B, H) float32, contiguous) receive the
    result in place; otherwise they are allocated."""
    _check("cell_fwd", zx, h, c, w_h, {"h_out": h_out, "c_out": c_out})
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
    _on_card("cell_fwd", {"zx": zx, "h": h, "c": c, "w_h": w_h,
                          "h_out": h_out, "c_out": c_out}, h.device)
    B, H = h.shape
    fn = _kernel("cifg_cell_fwd")
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


def cell_bwd(zx, w_h, h, c, dh_new, dc_new):
    """The reverse of one CIFG step → (dzx (B, 3H), dh (B, H), dc (B, H),
    dw_h (H, 3H)), all float32; the products over compute-dtype operands
    (``w_h.dtype``). Inputs as `cell_fwd`'s, plus the cotangents dh', dc'
    (B, H) float32."""
    _check("cell_bwd", zx, h, c, w_h, {"dh_new": dh_new, "dc_new": dc_new})
    if h.device.type == "cpu":
        return cell_bwd_ref(zx, w_h, h, c, dh_new, dc_new)
    if h.device.type != "cuda":
        raise ValueError(f"cell_bwd: unsupported device {h.device}")
    dzx = torch.empty_like(zx)
    dh, dc = torch.empty_like(h), torch.empty_like(c)
    dwh = torch.empty(w_h.shape, dtype=torch.float32, device=h.device)
    _on_card("cell_bwd", {"zx": zx, "w_h": w_h, "h": h, "c": c,
                          "dh_new": dh_new, "dc_new": dc_new}, h.device)
    B, H = h.shape
    fn = _kernel("cifg_cell_bwd")
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = fn(zx.data_ptr(), w_h.data_ptr(),
                 int(w_h.dtype == torch.bfloat16), h.data_ptr(), c.data_ptr(),
                 dh_new.data_ptr(), dc_new.data_ptr(), dzx.data_ptr(),
                 dh.data_ptr(), dc.data_ptr(), dwh.data_ptr(), B, H, stream)
    if err != 0:
        raise RuntimeError(f"cifg_cell_bwd kernel launch failed with CUDA "
                           f"error {err} (B={B}, H={H}, w_h {w_h.dtype})")
    LAUNCHES["cifg_cell_bwd"] += 1
    return dzx, dh, dc, dwh


class _CifgStep(torch.autograd.Function):
    """One fused step; backward = the fused reverse step (`cell_bwd`)."""

    @staticmethod
    def forward(ctx, zx, h, c, w_h, cd):
        f32 = torch.float32
        args = (zx.to(f32).contiguous(), h.to(f32).contiguous(),
                c.to(f32).contiguous(), w_h.to(cd).contiguous())
        ctx.save_for_backward(*args)
        ctx.dtypes = (zx.dtype, h.dtype, c.dtype, w_h.dtype)
        return cell_fwd(*args)

    @staticmethod
    def backward(ctx, dh_new, dc_new):
        zx, h, c, w = ctx.saved_tensors
        dzx, dh, dc, dwh = cell_bwd(zx, w, h, c,
                                    dh_new.float().contiguous(),
                                    dc_new.float().contiguous())
        tz, th, tc, tw = ctx.dtypes
        return dzx.to(tz), dh.to(th), dc.to(tc), dwh.to(tw), None


def cifg_step(zx, h, c, w_h, *, compute_dtype=None):
    """Fused CIFG step with the fused backward. zx (B, 3H), h and c (B, H),
    w_h (H, 3H); ``compute_dtype`` is the product dtype (``None`` =
    ``w_h.dtype``). Returns (h', c') float32; the gradient of ``w_h`` comes
    back in ``w_h.dtype``. Pass ``w_h`` already in the compute dtype to
    avoid a cast per call."""
    if zx.dim() != 2 or h.dim() != 2 or c.shape != h.shape \
            or tuple(zx.shape) != (h.shape[0], 3 * h.shape[1]) \
            or tuple(w_h.shape) != (h.shape[1], 3 * h.shape[1]):
        raise ValueError(
            f"cifg_step: expected zx (B, 3H), h/c (B, H), w_h (H, 3H) — got "
            f"zx {tuple(zx.shape)}, h {tuple(h.shape)}, c {tuple(c.shape)}, "
            f"w_h {tuple(w_h.shape)}")
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    return _CifgStep.apply(zx, h, c, w_h, cd)


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


class _CifgSequence(torch.autograd.Function):
    """The whole recurrence with the reference's time-fused backward."""

    @staticmethod
    def forward(ctx, zx, h0, c0, w_h, cell, cd, remat):
        hs, cs = cifg_states(zx, h0, c0, w_h, cell=cell, compute_dtype=cd)
        ctx.cell, ctx.cd, ctx.remat = cell, cd, remat
        saved = (zx, h0, c0, w_h) if remat else (zx, h0, c0, w_h, hs, cs)
        ctx.save_for_backward(*saved)
        return hs, hs[-1].clone(), cs[-1].clone()

    @staticmethod
    def backward(ctx, dhs, dhf, dcf):
        """Everything that does not depend on the sequential (dh, dc)
        recursion is batched over time: the gate recompute is one
        (S·B, H) @ (H, 3H) product over compute-dtype operands with float32
        sums, as in the forward, so the linearization point is the
        forward's; ``dw_h`` is one (H, S·B) @ (S·B, 3H) product after the
        loop. Each reverse step does the elementwise (dh, dc) update and one
        float32 ``dz @ w_hᵀ``."""
        if ctx.remat:
            zx, h0, c0, w_h = ctx.saved_tensors
            hs, cs = cifg_states(zx, h0, c0, w_h, cell=ctx.cell,
                                 compute_dtype=ctx.cd)
        else:
            zx, h0, c0, w_h, hs, cs = ctx.saved_tensors
        f32 = torch.float32
        S, B, H = hs.shape
        h_prev = torch.cat([h0.to(f32)[None], hs[:-1]])
        c_prev = torch.cat([c0.to(f32)[None], cs[:-1]])
        z = zx.to(f32) + torch.mm(
            round_to(h_prev.reshape(S * B, H), ctx.cd),
            round_to(w_h, ctx.cd)).reshape(S, B, 3 * H)
        f = torch.sigmoid(z[..., :H] + 1.0)
        o = torch.sigmoid(z[..., H:2 * H])
        g = torch.tanh(z[..., 2 * H:])
        t = torch.tanh(cs)
        # per-step cotangent factors, batched over time:
        #   dct = dc + dh·A;  dzf = dct·Bf;  dzo = dh·Co;  dzg = dct·Dg
        A = o * (1.0 - t * t)
        Bf = (c_prev - g) * f * (1.0 - f)
        Co = t * o * (1.0 - o)
        Dg = (1.0 - f) * (1.0 - g * g)
        w_t = w_h.to(f32).t()
        dhs = dhs.to(f32)
        dh_next, dc_next = dhf.to(f32), dcf.to(f32)
        dz = torch.empty_like(z)
        for s in range(S - 1, -1, -1):
            dh = dh_next + dhs[s]
            dct = dc_next + dh * A[s]
            torch.mul(dct, Bf[s], out=dz[s, :, :H])
            torch.mul(dh, Co[s], out=dz[s, :, H:2 * H])
            torch.mul(dct, Dg[s], out=dz[s, :, 2 * H:])
            dh_next = torch.mm(dz[s], w_t)
            dc_next = dct * f[s]
        dwh = torch.mm(h_prev.reshape(S * B, H).t(), dz.reshape(S * B, -1))
        return (dz.to(zx.dtype), dh_next.to(h0.dtype), dc_next.to(c0.dtype),
                dwh.to(w_h.dtype), None, None, None)


def cifg_sequence(zx, h0, c0, w_h, *, cell: str = "seq", compute_dtype=None,
                  remat: bool = False):
    """Whole-sequence CIFG recurrence with the time-fused backward.

    zx (S, B, 3H) float32, time-major (``x @ w_x + b_gates`` for every
    step); h0, c0 (B, H); w_h (H, 3H) as the parameter (cast to the compute
    dtype inside). Returns ``(hs (S, B, H) float32, (h_fin, c_fin))``.
    ``cell="fused"`` launches the cell kernel once per step (the plain cell
    for CPU tensors), ``"seq"`` steps the plain cell; both share the
    backward. ``remat=True`` keeps no state stacks for the backward and
    recomputes them there; the gradients are bitwise those without it."""
    _check_sequence("cifg_sequence", zx, h0, c0, w_h)
    if cell not in ("fused", "seq"):
        raise ValueError(f"cell must be 'fused' or 'seq', got {cell!r}")
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    hs, h_fin, c_fin = _CifgSequence.apply(zx, h0, c0, w_h, cell, cd,
                                           bool(remat))
    return hs, (h_fin, c_fin)
