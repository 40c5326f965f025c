"""Plain PyTorch CIFG recurrent cell: the oracle of the CUDA cell kernel and
the ``cell_path="seq"`` / ``"ref"`` model path.

One step given the hoisted input projection ``zx = x_t @ w_x + b_gates``:
``z = zx + h @ w_h`` with the product in the compute dtype and a float32 sum,
then the gates ``[f | o | g]`` (each ``H`` wide) in float32:
f = σ(z_f + 1) (forget bias 1), o = σ(z_o), g = tanh(z_g),
c' = f·c + (1 − f)·g (CIFG: i = 1 − f), h' = o·tanh(c').

`cifg_cell_ref` and `cell_bwd_seq_ref` also take a leading client axis (a
chunk of clients, each with its own ``w_h``; the forward also one ``w_h``
for all), as the kernels do: each client's result is the same bits as its
one-client call (`utils.numerics.client_mm`).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.utils.numerics import (client_mm, round_to, rowstable_mm,
                                       torch_dtype)


def _sigmoid(x):
    """σ(x) = 1 / (1 + exp(−x)), the kernels' formula. PyTorch's CPU
    ``sigmoid`` computes an element by its vector or its scalar code
    depending on where the element falls in the tensor, and the two differ
    in the last bit; ``exp`` and the arithmetic do not, so a client's gates
    keep their bits whatever the width of the chunk."""
    return 1.0 / (1.0 + torch.exp(-x))


def _per_client(h, w):
    """``w`` with the client axis of ``h`` (C, B, H): as it is when it has
    one, else shared by every client."""
    return w if w.dim() == 3 else w.expand((h.shape[0],) + tuple(w.shape))


def cifg_cell_ref(zx, h, c, w_h, *, compute_dtype=None):
    """zx (B, 3H) f32; h, c (B, H) f32; w_h (H, 3H). With a client axis: zx
    (C, B, 3H), h and c (C, B, H), w_h (C, H, 3H) or (H, 3H).
    ``compute_dtype`` is the matmul dtype (``None`` = ``w_h.dtype``).
    Returns (h', c') f32."""
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    hidden = h.shape[-1]
    hc, w = round_to(h, cd), round_to(w_h, cd)
    z = zx.to(torch.float32) + (client_mm(hc, _per_client(h, w))
                                if h.dim() == 3 else rowstable_mm(hc, w))
    f = _sigmoid(z[..., :hidden] + 1.0)
    o = _sigmoid(z[..., hidden:2 * hidden])
    g = torch.tanh(z[..., 2 * hidden:])
    c_new = f * c.to(torch.float32) + (1.0 - f) * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def cell_bwd_ref(zx, w_h, h, c, dh_new, dc_new):
    """The reverse of one CIFG step, the plain version of the CUDA kernel
    ``csrc/cifg_cell_bwd.cu`` and of the reference's Pallas ``cell_bwd``.

    zx (B, 3H) f32; w_h (H, 3H) in the compute dtype; h, c, dh', dc' (B, H)
    f32. Recomputes the gates, then
    dct = dc' + dh'·o·(1 − tanh²c'), dz = [dct·(c−g)·f(1−f) | dh'·tanh(c')·
    o(1−o) | dct·(1−f)(1−g²)], dh = dz·W_hᵀ, dc = dct·f, dW_h = hᵀ·dz, the
    two products over operands in the compute dtype with float32 sums.
    Returns (dzx (B, 3H), dh (B, H), dc (B, H), dw_h (H, 3H)), all f32."""
    cd = w_h.dtype
    H = h.shape[-1]
    w = round_to(w_h, cd)
    hc = round_to(h, cd)
    z = zx.to(torch.float32) + rowstable_mm(hc, w)
    f = _sigmoid(z[:, :H] + 1.0)
    o = _sigmoid(z[:, H:2 * H])
    g = torch.tanh(z[:, 2 * H:])
    t = torch.tanh(f * c + (1.0 - f) * g)
    dct = dc_new + dh_new * o * (1.0 - t * t)
    dz = torch.cat([dct * (c - g) * f * (1.0 - f),
                    dh_new * t * o * (1.0 - o),
                    dct * (1.0 - f) * (1.0 - g * g)], dim=1)
    dzc = round_to(dz, cd)
    return dz, rowstable_mm(dzc, w.t()), dct * f, hc.t().mm(dzc)


def cell_bwd_seq_ref(z, cs, c0, dhs, dh_fin, dc_fin, w_h):
    """The reverse recursion of a CIFG sequence, the plain version of the
    CUDA kernel ``cifg_cell_bwd_seq`` (``csrc/cifg_cell_bwd.cu``) and of the
    reverse scan in the reference's ``_cifg_sequence_bwd``.

    z (S, B, 3H) the gate pre-activations, cs (S, B, H) the cell states, c0
    (B, H), the cotangents dhs (S, B, H), dh_fin and dc_fin (B, H), w_h
    (H, 3H); float32 throughout, the product too. With a client axis every
    argument has a leading C (w_h (C, H, 3H)); the products are then one
    ``torch.mm`` a client (`client_mm`). The per-step factors
    A = o(1 − t²), Bf = (c_{s−1} − g)·f(1 − f), Co = t·o(1 − o),
    Dg = (1 − f)(1 − g²) (t = tanh c_s) are formed batched over time; then
    for s = S−1 … 0: dh += dhs[s], dct = dc + dh·A, dz[s] = [dct·Bf | dh·Co |
    dct·Dg], dh = dz[s] @ w_hᵀ, dc = dct·f. Returns (dz, dh0, dc0)."""
    f32 = torch.float32
    S, B, H = cs.shape[-3:]
    c_prev = torch.cat([c0.to(f32).unsqueeze(-3), cs[..., :-1, :, :]],
                       dim=-3)
    f = _sigmoid(z[..., :H] + 1.0)
    o = _sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:])
    t = torch.tanh(cs)
    A = o * (1.0 - t * t)
    Bf = (c_prev - g) * f * (1.0 - f)
    Co = t * o * (1.0 - o)
    Dg = (1.0 - f) * (1.0 - g * g)
    w_t = w_h.to(f32).transpose(-1, -2)
    mm = partial(client_mm, rows=False) if cs.dim() == 4 else torch.mm
    dhs = dhs.to(f32)
    dh_next, dc_next = dh_fin.to(f32), dc_fin.to(f32)
    dz = torch.empty_like(z)
    for s in range(S - 1, -1, -1):
        at = (Ellipsis, s, slice(None), slice(None))
        dh = dh_next + dhs[at]
        dct = dc_next + dh * A[at]
        torch.mul(dct, Bf[at], out=dz[..., s, :, :H])
        torch.mul(dh, Co[at], out=dz[..., s, :, H:2 * H])
        torch.mul(dct, Dg[at], out=dz[..., s, :, 2 * H:])
        dh_next = mm(dz[at], w_t)
        dc_next = dct * f[at]
    return dz, dh_next, dc_next
