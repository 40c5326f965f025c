"""``dp_clip_accumulate`` (``dp_clip.cu``: one leaf of n elements, C
clients' deltas scaled by their clip factors and added to the running sum
in one launch): its bytes and operations. Read once: the sum and C deltas
(float32) and C factors; written: the sum. Operations: a multiply-add a
delta element, float32 on the CUDA cores."""
from __future__ import annotations

from port_bench.harness.peaks import bound_s

KERNEL_NAMES = ("clip_accumulate_kernel",)
KERNELS_PER_CALL = 1


def counts(C: int, n: int):
    return (8 + 4 * C) * n + 4 * C, {"float32": 2 * C * n}


def bound(C: int = 1, n: int = 1):
    return bound_s(*counts(C, n))
