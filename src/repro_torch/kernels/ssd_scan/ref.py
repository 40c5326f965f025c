"""Plain PyTorch versions of the SSD scan: the CPU path of the `ssd_scan`
wrapper and the oracles the CUDA kernel is held against on the card.

* `ssd_scan_ref` — the sequential token-by-token recurrence (the reference's
  ``ssd_scan/ref.py``);
* `ssd_chunked` — the chunked form the kernel computes (the reference model's
  ``mamba2.ssd_chunked``), which `repro_torch.models.mamba2` runs on the CPU.
"""
from __future__ import annotations

import torch

CHUNK = 128


def ssd_scan_ref(x, dt, Bm, Cm, A, h0=None):
    """h_t = e^{A·dt_t} h_{t-1} + dt_t·B_t⊗x_t, y_t = C_t·h_t, one token at a
    time. x: (B,S,H,p); dt: (B,S,H); Bm, Cm: (B,S,N); A: (H,); h0
    (B,H,p,N) or ``None`` for zeros. Returns (y (B,S,H,p), final state
    (B,H,p,N)), float32."""
    Bsz, S, H, p = x.shape
    N = Bm.shape[-1]
    x, dt, Bm, Cm = (t.float() for t in (x, dt, Bm, Cm))
    h = (torch.zeros((Bsz, H, p, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A[None, :])                   # (B,H)
        dBx = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], Bm[:, t], x[:, t])
        h = decay[:, :, None, None] * h + dBx
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def ssd_chunked(xh, dt, Bc, Cc, A, h0):
    """Chunked SSD scan (chunks of ``min(CHUNK, S)``). Within a chunk the
    dual quadratic form (C·Bᵀ ∘ L ∘ dt)·x, with L the exponentiated segment
    sums of dt·A on the lower triangle; across chunks the carried state,
    e^{cum}·C·stateᵀ, and its update e^{cum_Q}·state + xᵀ·(dt·e^{cum_Q−cum}·B).

    xh: (B,S,H,p); dt: (B,S,H) float32; Bc, Cc: (B,S,N); A: (H,) negative;
    h0: (B,H,p,N) float32. Returns y (B,S,H,p) float32 and the final state.
    ``S`` must be a multiple of ``min(CHUNK, S)``, as in the reference."""
    Bsz, S, H, p = xh.shape
    Q = min(CHUNK, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence length {S} is not a "
                         f"multiple of the chunk {Q}")
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    h = h0
    ys = []
    for c0 in range(0, S, Q):
        xc = xh[:, c0:c0 + Q].float()                 # (B,Q,H,p)
        dtc = dt[:, c0:c0 + Q].float()                # (B,Q,H)
        bc = Bc[:, c0:c0 + Q].float()                 # (B,Q,N)
        cc = Cc[:, c0:c0 + Q].float()
        cum = torch.cumsum(dtc * A[None, None, :], dim=1)   # (B,Q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,H)
        # exp only on the lower triangle: above it seg > 0 and can overflow
        Lmat = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                         float("-inf")))
        scores = torch.einsum("bqn,bsn->bqs", cc, bc)
        w = scores[:, :, :, None] * Lmat * dtc[:, None, :, :]
        y_intra = torch.einsum("bqsh,bshp->bqhp", w, xc)
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bqn,bhpn->bqhp", cc, h)
        decay_out = torch.exp(cum[:, -1:, :] - cum)   # (B,Q,H)
        dB = (dtc * decay_out)[..., None] * bc[:, :, None, :]
        h = torch.exp(cum[:, -1, :])[:, :, None, None] * h + torch.einsum(
            "bqhn,bqhp->bhpn", dB, xc)
        ys.append(y_intra + y_inter)
    return torch.cat(ys, dim=1), h
