"""``cifg_cell_bwd_seq`` (``cifg_cell_bwd.cu``, the reverse recursion of a
sequence in one launch, a chunk of C clients in one launch): its bytes and
operations.

Read once, per client, all float32: z (S, B, 3H), cs (S, B, H), c0, dh_fin,
dc_fin (B, H), dhs (S, B, H), w_h (H, 3H); written once: dz (S, B, 3H),
dh0 and dc0 (B, H). Operations: the products dz @ w_hᵀ, 2·S·B·H·3H, and
about 30 a (step, row, unit) for the elementwise step (exp and tanh
counted as one), at the CUDA cores' float32 rate.
"""
from __future__ import annotations

from port_bench.harness.peaks import bound_s

KERNEL_NAMES = ("cifg_bwd_seq_kernel", "cifg_bwd_seq_wide_kernel")
KERNELS_PER_CALL = 1


def counts(C: int, S: int, B: int, H: int):
    nbytes = C * 4 * (2 * S * B * 3 * H + 2 * S * B * H + 5 * B * H
                      + 3 * H * H)
    ops = C * (2 * S * B * H * 3 * H + 30 * S * B * H)
    return nbytes, {"float32": ops}


def bound(C: int = 1, S: int = 1, B: int = 1, H: int = 256):
    return bound_s(*counts(C, S, B, H))
