"""``cifg_cell_fwd`` (``cifg_cell_fwd.cu``, one launch a sequence, a chunk
of C clients in one launch): its bytes and operations.

Read once: zx (C, S, B, 3H) float32, h0 and c0 (C, B, H) float32, w_h
(C, H, 3H) in the compute dtype (``w_bytes`` a value); written once: the
state stacks hs and cs (C, S, B, H) float32. Operations: h @ w_h, 2·S·B·H·3H
a client, on the bf16 tensor cores (float32 ``w_h``: the CUDA cores).
"""
from __future__ import annotations

from port_bench.harness.peaks import bound_s

KERNEL_NAMES = ("cifg_seq_kernel", "cifg_seq_wide_kernel")
KERNELS_PER_CALL = 1


def counts(C: int, S: int, B: int, H: int, w_bytes: int = 2):
    nbytes = C * ((S * B * 3 * H + 2 * B * H + 2 * S * B * H) * 4
                  + 3 * H * H * w_bytes)
    rate = "bfloat16" if w_bytes == 2 else "float32"
    return nbytes, {rate: C * 2 * S * B * H * 3 * H}


def bound(C: int = 1, S: int = 1, B: int = 1, H: int = 256,
          w_bytes: int = 2):
    return bound_s(*counts(C, S, B, H, w_bytes))
