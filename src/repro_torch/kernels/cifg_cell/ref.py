"""Plain PyTorch CIFG recurrent cell: the oracle of the CUDA cell kernel and
the ``cell_path="seq"`` / ``"ref"`` model path.

One step given the hoisted input projection ``zx = x_t @ w_x + b_gates``:
``z = zx + h @ w_h`` with the product in the compute dtype and a float32 sum,
then the gates ``[f | o | g]`` (each ``H`` wide) in float32:
f = σ(z_f + 1) (forget bias 1), o = σ(z_o), g = tanh(z_g),
c' = f·c + (1 − f)·g (CIFG: i = 1 − f), h' = o·tanh(c').
"""
from __future__ import annotations

import torch

from repro_torch.utils.numerics import round_to, rowstable_mm, torch_dtype


def cifg_cell_ref(zx, h, c, w_h, *, compute_dtype=None):
    """zx (B, 3H) f32; h, c (B, H) f32; w_h (H, 3H). ``compute_dtype`` is
    the matmul dtype (``None`` = ``w_h.dtype``). Returns (h', c') f32."""
    cd = torch_dtype(compute_dtype, default=w_h.dtype)
    hidden = h.shape[-1]
    z = zx.to(torch.float32) + rowstable_mm(round_to(h, cd), round_to(w_h, cd))
    f = torch.sigmoid(z[:, :hidden] + 1.0)
    o = torch.sigmoid(z[:, hidden:2 * hidden])
    g = torch.tanh(z[:, 2 * hidden:])
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
    f = torch.sigmoid(z[:, :H] + 1.0)
    o = torch.sigmoid(z[:, H:2 * H])
    g = torch.tanh(z[:, 2 * H:])
    t = torch.tanh(f * c + (1.0 - f) * g)
    dct = dc_new + dh_new * o * (1.0 - t * t)
    dz = torch.cat([dct * (c - g) * f * (1.0 - f),
                    dh_new * t * o * (1.0 - o),
                    dct * (1.0 - f) * (1.0 - g * g)], dim=1)
    dzc = round_to(dz, cd)
    return dz, rowstable_mm(dzc, w.t()), dct * f, hc.t().mm(dzc)
