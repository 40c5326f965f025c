"""The CIFG cell kernels' wrappers and the ops built on them.

``cell_seq_fwd`` / ``cell_fwd``, ``cell_bwd_seq`` and ``cell_bwd`` wrap the
CUDA kernels ``csrc/cifg_cell_fwd.cu`` and ``csrc/cifg_cell_bwd.cu`` (which
replace the Pallas ``cell_fwd`` and ``cell_bwd`` of the reference). The
forward kernel runs a whole sequence in one launch (``cell_seq_fwd``); one
step (``cell_fwd``) is that kernel at S = 1. ``cell_bwd_seq`` runs the
reverse recursion of a whole sequence in one launch; ``cell_bwd`` is the
reverse of one step. They take the model's natural layout — zx (S, B, 3H)
or (B, 3H), h and c (B, H) float32, w_h (H, 3H) in the compute dtype — with
no packing or tile padding: the kernels mask ragged B and H themselves, and
take any H (each kernel picks its route from H alone). ``cell_seq_fwd``,
``cell_fwd`` and ``cell_bwd_seq`` also take a leading client axis (zx
(C, S, B, 3H), states (C, B, H), w_h (C, H, 3H) per client or (H, 3H)
shared): a cohort chunk's clients in one launch, each client's result the
same bits as its one-client launch. For tensors on the CPU a wrapper
computes the plain version (`ref.py`); for CUDA tensors it launches its
kernel or raises.

``LAUNCHES[name]`` counts kernel launches (only those), so a run can show
that its path went through the kernels.

* ``cifg_step`` — one step with a custom backward: the forward kernel, and
  ``cell_bwd`` as its gradient (the reference's ``_cifg_step`` custom VJP).
  Differentiating through ``decode_step`` reaches it.
* ``cifg_sequence`` — the whole recurrence with the reference's time-fused
  backward (``_cifg_sequence_fwd`` / ``_cifg_sequence_bwd``): the forward
  is one launch of the sequence kernel (``cell="fused"``) or steps the
  plain cell (``"seq"``); the backward recomputes the gates in one product
  over all steps, runs the reverse recursion (one ``cell_bwd_seq`` launch
  for ``"fused"``, the plain loop of one ``dz @ w_hᵀ`` per step for
  ``"seq"``) and forms ``dw_h`` in one product. Training's forward and
  backward both go through it.
* ``cifg_states`` — the forward-only recurrence of the prefills (and of
  ``cifg_sequence``'s forward), one launch writing each step's state
  straight into preallocated (S, B, H) stacks.

``cifg_sequence`` and ``cifg_states`` carry the client axis through; with
it the backward's two products run per client (`utils.numerics.client_mm`)
and the reverse recursion is one ``cell_bwd_seq`` launch for the chunk.
"""
from __future__ import annotations

import ctypes
from functools import partial

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cifg_cell.ref import (cell_bwd_ref, cell_bwd_seq_ref,
                                               cifg_cell_ref)
from repro_torch.utils.numerics import client_mm, round_to, torch_dtype

LAUNCHES = {"cifg_cell_fwd": 0, "cifg_cell_bwd": 0, "cifg_cell_bwd_seq": 0}

_COMPUTE_DTYPES = (torch.bfloat16, torch.float32)

_p, _i = ctypes.c_void_p, ctypes.c_int
# counter → (library, C entry point, its argument types)
_ENTRIES = {
    "cifg_cell_fwd": ("cifg_cell_fwd", "cifg_cell_seq_fwd",
                      [_p, _p, _p, _p, _i, _i, _p, _p, _i, _i, _i, _i, _p]),
    "cifg_cell_bwd": ("cifg_cell_bwd", "cifg_cell_bwd",
                      [_p, _p, _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i,
                       _p]),
    "cifg_cell_bwd_seq": ("cifg_cell_bwd", "cifg_cell_bwd_seq",
                          [_p] * 10 + [_i] * 4 + [_p]),
}
# route → (library, C entry point of its occupancy query, argument types)
_OCCUPANCY = {
    "cifg_cell_fwd": ("cifg_cell_fwd", "cifg_cell_fwd_max_clusters",
                      [_i, _i, _i, ctypes.POINTER(ctypes.c_int)]),
    "cifg_cell_bwd_seq": ("cifg_cell_bwd", "cifg_cell_bwd_seq_max_clusters",
                          [_i, _i, ctypes.POINTER(ctypes.c_int)]),
}


def _kernel(name: str, entries=_ENTRIES):
    """The C entry point behind wrapper ``name``."""
    library, symbol, argtypes = entries[name]
    fn = getattr(build.load(library), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def max_active_clusters(name: str, B: int, H: int,
                        w_dtype: torch.dtype = torch.float32) -> int:
    """How many clusters of ``name``'s kernel (``"cifg_cell_fwd"`` in
    ``w_dtype``, or ``"cifg_cell_bwd_seq"``) the current CUDA card holds at
    once at (B, H) (``cudaOccupancyMaxActiveClusters`` for the route H
    picks). A launch has C · ceil(B / 16) clusters; more than this run in
    waves."""
    fn = _kernel(name, _OCCUPANCY)
    out = ctypes.c_int(0)
    args = ((int(w_dtype == torch.bfloat16),) if name == "cifg_cell_fwd"
            else ())
    err = fn(*args, B, H, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed with CUDA error "
                           f"{err} (B={B}, H={H})")
    return out.value


def _on_card(name: str, tensors: dict, device) -> None:
    """Raise unless every tensor is contiguous and on ``device``."""
    for tname, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {tname} is on {t.device}, h on "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")


def _check(name, zx, h, c, w_h, states=None):
    """Shapes and dtypes: zx (B, 3H), h and c and the extra (B, H)
    ``states`` (outputs or cotangents; ``None`` entries skipped) float32,
    w_h (H, 3H) bfloat16 or float32 — or all but w_h with a leading client
    axis C, and w_h (C, H, 3H) or (H, 3H)."""
    if h.dim() not in (2, 3):
        raise ValueError(f"{name}: h must be (B, H) or (C, B, H), got "
                         f"{tuple(h.shape)}")
    lead, (B, H) = tuple(h.shape[:-2]), tuple(h.shape[-2:])
    named = {"zx": zx, "h": h, "c": c, **(states or {})}
    shapes = {"zx": lead + (B, 3 * H)}
    for tname, t in named.items():
        want = shapes.get(tname, lead + (B, H))
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name}: expected {tname} {want} for h "
                             f"{tuple(h.shape)}, got {tuple(t.shape)}")
    if tuple(w_h.shape) not in ((H, 3 * H), lead + (H, 3 * H)):
        raise ValueError(f"{name}: expected w_h {(H, 3 * H)} or "
                         f"{lead + (H, 3 * H)} for h {tuple(h.shape)}, got "
                         f"{tuple(w_h.shape)}")
    for tname, t in named.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
    if w_h.dtype not in _COMPUTE_DTYPES:
        raise TypeError(f"{name}: w_h must be bfloat16 or float32 (the "
                        f"compute dtype), got {w_h.dtype}")


def _launch_seq(zx, h0, c0, w_h, hs, cs):
    """One launch of the sequence kernel: zx (C, S, B, 3H), states
    (C, B, H), outputs (C, S, B, H), w_h (C, H, 3H) or shared (H, 3H) —
    or the same without C (one client), or for one step (…, B, 3H) and
    (…, B, H) views of the same memory."""
    _on_card("cifg_cell_fwd", {"zx": zx, "h": h0, "c": c0, "w_h": w_h,
                               "hs": hs, "cs": cs}, h0.device)
    B, H = h0.shape[-2:]
    C = h0.shape[0] if h0.dim() == 3 else 1
    S = zx.numel() // (C * B * 3 * H)
    per_client = int(w_h.dim() == 3)
    fn = _kernel("cifg_cell_fwd")
    with torch.cuda.device(h0.device):
        stream = torch.cuda.current_stream(h0.device).cuda_stream
        err = fn(zx.data_ptr(), h0.data_ptr(), c0.data_ptr(), w_h.data_ptr(),
                 int(w_h.dtype == torch.bfloat16), per_client, hs.data_ptr(),
                 cs.data_ptr(), C, S, B, H, stream)
    if err != 0:
        raise RuntimeError(f"cifg_cell_fwd kernel launch failed with CUDA "
                           f"error {err} (C={C}, S={S}, B={B}, H={H}, w_h "
                           f"{w_h.dtype})")
    LAUNCHES["cifg_cell_fwd"] += 1


def cell_fwd(zx, h, c, w_h, *, h_out=None, c_out=None):
    """One CIFG step → (h', c') float32, the product in ``w_h.dtype``: the
    sequence kernel at S = 1 (with a leading client axis, C clients).

    ``h_out`` / ``c_out`` (optional, h's shape, float32, contiguous) receive
    the result in place; otherwise they are allocated."""
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
    _launch_seq(zx, h, c, w_h, h_out, c_out)
    return h_out, c_out


def cell_seq_fwd(zx, h0, c0, w_h, *, hs=None, cs=None):
    """S CIFG steps from (h0, c0) in one launch → the state stacks (hs, cs),
    each (S, B, H) float32, the products in ``w_h.dtype``.

    zx (S, B, 3H), h0 and c0 (B, H) float32, w_h (H, 3H) bfloat16 or
    float32; with a client axis zx (C, S, B, 3H), h0 and c0 (C, B, H), w_h
    (C, H, 3H) (each client its own) or (H, 3H) (shared), and the stacks
    (C, S, B, H). ``hs`` / ``cs`` (optional, float32, contiguous) receive the
    result in place. For CPU tensors this is the plain recurrence; for CUDA
    tensors it launches the kernel (any H) or raises. ``hs[t]`` is bitwise
    the final state of a call over the first t + 1 steps and of t + 1
    chained `cell_fwd` calls, and a client's stacks are bitwise its
    one-client call's."""
    if zx.dim() not in (3, 4) or zx.shape[-3] < 1:
        raise ValueError(f"cell_seq_fwd: zx must be (S, B, 3H) or "
                         f"(C, S, B, 3H) with S >= 1, got {tuple(zx.shape)}")
    S = zx.shape[-3]
    _check("cell_seq_fwd", zx[..., 0, :, :], h0, c0, w_h)
    stack = tuple(h0.shape[:-2]) + (S,) + tuple(h0.shape[-2:])
    for tname, t in (("hs", hs), ("cs", cs)):
        if t is not None and (tuple(t.shape) != stack
                              or t.dtype != torch.float32):
            raise ValueError(f"cell_seq_fwd: {tname} must be float32 "
                             f"{stack}, got {tuple(t.shape)} {t.dtype}")
    if hs is None:
        hs = torch.empty(stack, dtype=torch.float32, device=h0.device)
    if cs is None:
        cs = torch.empty_like(hs)
    if h0.device.type == "cpu":
        h, c = h0, c0
        for t in range(S):
            h, c = cifg_cell_ref(zx[..., t, :, :], h, c, w_h)
            hs[..., t, :, :], cs[..., t, :, :] = h, c
        return hs, cs
    if h0.device.type != "cuda":
        raise ValueError(f"cell_seq_fwd: unsupported device {h0.device}")
    _launch_seq(zx, h0, c0, w_h, hs, cs)
    return hs, cs


def _check_sequence(name, zx, h0, c0, w_h):
    lead = tuple(h0.shape[:-2])
    if zx.dim() not in (3, 4) or h0.dim() != zx.dim() - 1 \
            or c0.shape != h0.shape or tuple(zx.shape[:-3]) != lead \
            or tuple(zx.shape[-2:]) != (h0.shape[-2], 3 * h0.shape[-1]) \
            or tuple(w_h.shape) != lead + (h0.shape[-1], 3 * h0.shape[-1]):
        raise ValueError(
            f"{name}: expected zx (S, B, 3H), h0/c0 (B, H), w_h (H, 3H), or "
            f"each with a leading client axis — got zx {tuple(zx.shape)}, "
            f"h0 {tuple(h0.shape)}, c0 {tuple(c0.shape)}, w_h "
            f"{tuple(w_h.shape)}")


def cell_bwd(zx, w_h, h, c, dh_new, dc_new):
    """The reverse of one CIFG step → (dzx (B, 3H), dh (B, H), dc (B, H),
    dw_h (H, 3H)), all float32; the products over compute-dtype operands
    (``w_h.dtype``). Inputs as `cell_fwd`'s, plus the cotangents dh', dc'
    (B, H) float32 (one client: no client axis)."""
    if h.dim() != 2:
        raise ValueError(f"cell_bwd: h must be (B, H), got {tuple(h.shape)}")
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


def cell_bwd_seq(z, cs, c0, dhs, dh_fin, dc_fin, w_h):
    """The reverse recursion of a whole CIFG sequence in one launch →
    (dz (S, B, 3H), dh0 (B, H), dc0 (B, H)), all float32: for s = S-1 … 0,
    dh += dhs[s], dct = dc + dh·A, dz[s] = [dct·Bf | dh·Co | dct·Dg],
    dh = dz[s] @ w_hᵀ, dc = dct·f, the factors formed from the gates of
    ``z`` and from ``cs`` and c_{s-1} (`ref.cell_bwd_seq_ref`).

    z (S, B, 3H) the gate pre-activations (zx + h_{s-1} @ w_h), cs (S, B, H)
    the cell states, c0 (B, H) the initial one, dhs (S, B, H), dh_fin and
    dc_fin (B, H) the cotangents, w_h (H, 3H): all float32 (the product is
    float32, as the reference's). With a client axis every argument and
    output has a leading C, w_h (C, H, 3H): the chunk's recursions in one
    launch. For CPU tensors this is the plain loop; for CUDA tensors it
    launches the kernel (any H) or raises."""
    if cs.dim() not in (3, 4) or cs.shape[-3] < 1:
        raise ValueError(f"cell_bwd_seq: cs must be (S, B, H) or "
                         f"(C, S, B, H) with S >= 1, got {tuple(cs.shape)}")
    lead = tuple(cs.shape[:-3])
    S, B, H = cs.shape[-3:]
    shapes = {"z": (S, B, 3 * H), "cs": (S, B, H), "c0": (B, H),
              "dhs": (S, B, H), "dh_fin": (B, H), "dc_fin": (B, H)}
    named = {"z": z, "cs": cs, "c0": c0, "dhs": dhs, "dh_fin": dh_fin,
             "dc_fin": dc_fin, "w_h": w_h}
    for tname, t in named.items():
        want = lead + (shapes[tname] if tname != "w_h" else (H, 3 * H))
        if tuple(t.shape) != want:
            raise ValueError(f"cell_bwd_seq: expected {tname} {want}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"cell_bwd_seq: {tname} must be float32, got "
                            f"{t.dtype}")
    if cs.device.type == "cpu":
        return cell_bwd_seq_ref(z, cs, c0, dhs, dh_fin, dc_fin, w_h)
    if cs.device.type != "cuda":
        raise ValueError(f"cell_bwd_seq: unsupported device {cs.device}")
    _on_card("cell_bwd_seq", named, cs.device)
    dz = torch.empty_like(z)
    dh0, dc0 = torch.empty_like(c0), torch.empty_like(c0)
    C = lead[0] if lead else 1
    fn = _kernel("cifg_cell_bwd_seq")
    with torch.cuda.device(cs.device):
        stream = torch.cuda.current_stream(cs.device).cuda_stream
        err = fn(z.data_ptr(), cs.data_ptr(), c0.data_ptr(), dhs.data_ptr(),
                 dh_fin.data_ptr(), dc_fin.data_ptr(), w_h.data_ptr(),
                 dz.data_ptr(), dh0.data_ptr(), dc0.data_ptr(), C, S, B, H,
                 stream)
    if err != 0:
        raise RuntimeError(f"cifg_cell_bwd_seq kernel launch failed with "
                           f"CUDA error {err} (C={C}, S={S}, B={B}, H={H})")
    LAUNCHES["cifg_cell_bwd_seq"] += 1
    return dz, dh0, dc0


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
    (hs, cs), each (S, B, H) float32. zx (S, B, 3H) is time-major. With a
    client axis: zx (C, S, B, 3H), h0 and c0 (C, B, H), w_h (C, H, 3H),
    stacks (C, S, B, H).

    ``cell="fused"`` launches the sequence kernel once (the plain cell for
    CPU tensors), writing each step's state into the stacks;
    ``cell="seq"`` steps the plain cell. The recurrence is causal, so
    ``(hs[t], cs[t])`` of a right-padded run equals the final state of an
    unpadded run of ``t + 1`` steps."""
    _check_sequence("cifg_states", zx, h0, c0, w_h)
    if cell not in ("fused", "seq"):
        raise ValueError(f"cell must be 'fused' or 'seq', got {cell!r}")
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    f32 = torch.float32
    S = zx.shape[-3]
    zx = zx.to(f32).contiguous()
    hs = torch.empty(tuple(h0.shape[:-2]) + (S,) + tuple(h0.shape[-2:]),
                     dtype=f32, device=h0.device)
    cs = torch.empty_like(hs)
    h, c = h0.to(f32).contiguous(), c0.to(f32).contiguous()
    if cell == "fused":
        return cell_seq_fwd(zx, h, c, w_h.to(cd).contiguous(), hs=hs, cs=cs)
    for t in range(S):
        h, c = cifg_cell_ref(zx[..., t, :, :], h, c, w_h, compute_dtype=cd)
        hs[..., t, :, :], cs[..., t, :, :] = h, c
    return hs, cs


def _one_mm(a, b):
    """``client_mm``'s call for one client without a client axis:
    ``torch.mm`` of the single matrices."""
    return torch.mm(a[0], b[0])[None]


class _CifgSequence(torch.autograd.Function):
    """The whole recurrence with the reference's time-fused backward."""

    @staticmethod
    def forward(ctx, zx, h0, c0, w_h, cell, cd, remat):
        hs, cs = cifg_states(zx, h0, c0, w_h, cell=cell, compute_dtype=cd)
        ctx.cell, ctx.cd, ctx.remat = cell, cd, remat
        saved = (zx, h0, c0, w_h) if remat else (zx, h0, c0, w_h, hs, cs)
        ctx.save_for_backward(*saved)
        return hs, hs[..., -1, :, :].clone(), cs[..., -1, :, :].clone()

    @staticmethod
    def backward(ctx, dhs, dhf, dcf):
        """Everything that does not depend on the sequential (dh, dc)
        recursion is batched over time: the gate recompute is one
        (S·B, H) @ (H, 3H) product over compute-dtype operands with float32
        sums, as in the forward, so the linearization point is the
        forward's; ``dw_h`` is one (H, S·B) @ (S·B, 3H) product after the
        recursion. The recursion itself (the elementwise (dh, dc) update
        and one float32 ``dz @ w_hᵀ`` a step) is one `cell_bwd_seq` launch
        for ``cell="fused"`` and its plain loop for ``"seq"``. With a
        client axis the two products run per client (`client_mm`) and the
        recursion is one launch for the chunk."""
        if ctx.remat:
            zx, h0, c0, w_h = ctx.saved_tensors
            hs, cs = cifg_states(zx, h0, c0, w_h, cell=ctx.cell,
                                 compute_dtype=ctx.cd)
        else:
            zx, h0, c0, w_h, hs, cs = ctx.saved_tensors
        f32 = torch.float32
        S, B, H = hs.shape[-3:]
        mm = partial(client_mm, rows=False) if hs.dim() == 4 else _one_mm
        h_prev = torch.cat([h0.to(f32).unsqueeze(-3), hs[..., :-1, :, :]],
                           dim=-3)
        rows = h_prev.reshape(-1, S * B, H)      # (C, S·B, H); C = 1 alone
        z = (zx.to(f32) + mm(round_to(rows, ctx.cd),
                             round_to(w_h.reshape(-1, H, 3 * H), ctx.cd)
                             ).reshape(zx.shape)).contiguous()
        recursion = cell_bwd_seq if ctx.cell == "fused" else cell_bwd_seq_ref
        dz, dh0, dc0 = recursion(
            z, cs.contiguous(), c0.to(f32).contiguous(),
            dhs.to(f32).contiguous(), dhf.to(f32).contiguous(),
            dcf.to(f32).contiguous(), w_h.to(f32).contiguous())
        dwh = mm(rows.transpose(1, 2),
                 dz.reshape(-1, S * B, 3 * H)).reshape(w_h.shape)
        return (dz.to(zx.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                dwh.to(w_h.dtype), None, None, None)


def cifg_sequence(zx, h0, c0, w_h, *, cell: str = "seq", compute_dtype=None,
                  remat: bool = False):
    """Whole-sequence CIFG recurrence with the time-fused backward.

    zx (S, B, 3H) float32, time-major (``x @ w_x + b_gates`` for every
    step); h0, c0 (B, H); w_h (H, 3H) as the parameter (cast to the compute
    dtype inside). Returns ``(hs (S, B, H) float32, (h_fin, c_fin))``. With
    a client axis (a chunk of clients, each with its own parameters) every
    argument and result has a leading C, w_h (C, H, 3H).
    ``cell="fused"`` launches the sequence kernel once (the plain cell for
    CPU tensors), ``"seq"`` steps the plain cell; both share the
    backward. ``remat=True`` keeps no state stacks for the backward and
    recomputes them there; the gradients are bitwise those without it."""
    _check_sequence("cifg_sequence", zx, h0, c0, w_h)
    if cell not in ("fused", "seq"):
        raise ValueError(f"cell must be 'fused' or 'seq', got {cell!r}")
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    hs, h_fin, c_fin = _CifgSequence.apply(zx, h0, c0, w_h, cell, cd,
                                           bool(remat))
    return hs, (h_fin, c_fin)
