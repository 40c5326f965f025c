"""``dp_sumsq`` (``dp_clip.cu``'s ``dp_sumsq_chunk``: a chunk of C clients'
sums of squares over every leaf, two CUDA kernels): its bytes and
operations. Read once: C·n float32 deltas; written: each client's norm,
clip factor and flag. Operations: a multiply-add an element, float32 on the
CUDA cores."""
from __future__ import annotations

from port_bench.harness.peaks import bound_s

KERNEL_NAMES = ("sumsq_stage1", "sumsq_stage2")
KERNELS_PER_CALL = 2


def counts(C: int, n: int):
    return 4 * C * n + 3 * 4 * C, {"float32": 2 * C * n}


def bound(C: int = 1, n: int = 1):
    return bound_s(*counts(C, n))
