"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W power limit), and the roofline bound of a piece of
work: the larger of its bytes over the HBM bandwidth and its operations
over the peak of the unit that runs them (each input byte read once, each
output byte written once)."""
from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bfloat16": 989e12,            # tensor cores, dense
    "float32": 67e12,              # CUDA cores
    "float32_3xtf32": 495e12 / 3,  # float32 products as three TF32 ones
}
# the whole step's model FLOPs are measured against the bf16 dense peak
MFU_PEAK = OPS_PER_S["bfloat16"]


def bound_s(nbytes: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): ``ops`` maps each rate of
    `OPS_PER_S` to the operations done at it, and their times add."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / OPS_PER_S[k] for k, n in ops.items())
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
