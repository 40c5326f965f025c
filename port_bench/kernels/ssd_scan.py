"""``ssd_scan`` (``ssd_scan.cu``: one call is three CUDA kernels, the chunk
states, the state pass and the chunk scan): its bytes and operations.

Read once: x (B, S, H, p), B and C (B, S, N) in bf16, dt (B, S, H) and A
((H,) shared or (B, H) a row) float32; written once: y (B, S, H, p) and
the final state (B, H, p, N) float32. Operations of the chunked scan from
a zero state, by the rate they run at: the float32 products in 3xTF32 on
the tensor cores, the scalings on the CUDA cores. B and C have no head
axis, so C·Bᵀ's lower triangle is needed once per (row, chunk); per (row,
head, chunk) the triangle's product with x and the state update, and C
times the carried state for every chunk after the first. The scalings: the
triangle by L and by dt, B by dt·decay, C by exp(cum).
"""
from __future__ import annotations

from port_bench.harness.peaks import bound_s

KERNEL_NAMES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                "ssd_chunk_scan_kernel")
KERNELS_PER_CALL = 3
CHUNK = 128


def counts(B: int, S: int, H: int, p: int, N: int, a_rows: bool = False,
           in_bytes: int = 2):
    Q, chunks = CHUNK, -(-S // CHUNK)
    tri = Q * (Q + 1) // 2
    products = (B * chunks * tri * 2 * N
                + B * H * (chunks * (tri * 2 * p + Q * N * 2 * p)
                           + (chunks - 1) * Q * N * p * 2))
    scalings = B * H * (chunks * (tri * 2 + Q * N) + (chunks - 1) * Q * N)
    x, bc = B * S * H * p, B * S * N
    nbytes = (in_bytes * (x + 2 * bc)
              + 4 * (B * S * H + (B * H if a_rows else H) + x
                     + B * H * p * N))
    return nbytes, {"float32_3xtf32": products, "float32": scalings}


def bound(B: int = 1, S: int = 128, H: int = 1, p: int = 64, N: int = 64,
          a_rows: bool = False, in_bytes: int = 2):
    return bound_s(*counts(B, S, H, p, N, a_rows, in_bytes))
