"""Numerics shared by the port's products.

**Compute dtype.** The reference multiplies in the model's compute dtype
(bfloat16 by default) and sums in float32 (``preferred_element_type``). The
port keeps that contract by rounding both operands to the compute dtype and
multiplying them as float32: a product of two bfloat16 values is exact in
float32, so this is the same arithmetic up to the order of the sum.

**Row stability.** The serving engine must match the single-session
reference token for token, and its length probe compares two prefills bit
for bit. A BLAS library may pick another algorithm, and so another order of
summation, for M=1 than for M=2 or M=256 (a GEMV against a tiled GEMM).
`rowstable_mm` therefore runs every product with the same M: the rows are
padded with zeros to a multiple of ``ROW_TILE`` and each block of
``ROW_TILE`` rows is one call of the same shape, so a row's value depends
neither on how many rows shared the call nor on where it sat.

**Client stability.** A chunk of clients trains as one batched program,
each client with its own weights, and a client's update must be the same
bits whatever the chunk's width is (`repro_torch.fl.client`).
`client_mm` runs those per-client products so that it is.
"""
from __future__ import annotations

from typing import Union

import torch

ROW_TILE = 256

DtypeLike = Union[str, torch.dtype, None]


def torch_dtype(dtype: DtypeLike, default: torch.dtype = torch.float32
                ) -> torch.dtype:
    """``"bfloat16"`` / ``torch.bfloat16`` / ``None`` → a ``torch.dtype``."""
    if dtype is None:
        return default
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def round_to(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``x`` to ``dtype`` and hold the result in float32."""
    return x.to(dtype).to(torch.float32)


def rowstable_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a (M, K) @ b (K, N)`` in float32, computed in blocks of exactly
    ``ROW_TILE`` rows so that each row's result is independent of ``M``."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"rowstable_mm: expected (M, K) @ (K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    M = a.shape[0]
    n_blocks = max(1, -(-M // ROW_TILE))
    if M != n_blocks * ROW_TILE:
        padded = a.new_zeros((n_blocks * ROW_TILE, a.shape[1]))
        padded[:M] = a
        a = padded
    blocks = [torch.mm(a[i * ROW_TILE:(i + 1) * ROW_TILE], b)
              for i in range(n_blocks)]
    out = blocks[0] if n_blocks == 1 else torch.cat(blocks)
    return out[:M]


def _widen(t: torch.Tensor) -> torch.Tensor:
    """(1, M, K) → (2, M, K), the added matrix zero, in ``t``'s layout
    (row-major, or the transpose of row-major), so that the library sees the
    same operand as in a batch of clients."""
    if t.stride(-1) != 1:
        return _widen(t.transpose(1, 2)).transpose(1, 2)
    return torch.cat([t, torch.zeros_like(t)])


def client_mm(a: torch.Tensor, b: torch.Tensor, *, rows: bool = True
              ) -> torch.Tensor:
    """Per-client products ``a (C, M, K) @ b (C, K, N)`` in float32, each
    client's result the same bits whatever C is and wherever the client
    sits. ``rows=True`` pads each client's rows to a multiple of
    ``ROW_TILE`` first, as `rowstable_mm` does.

    On the CPU: one product per client (`rowstable_mm`, or ``torch.mm``
    for ``rows=False``), the call a one-client program makes; MKL splits a
    long K over its threads, and a batched call could change a client's bits
    with C. On CUDA: one ``torch.bmm`` over at least two clients (a single
    client is widened by a zero matrix). cuBLAS takes another algorithm for
    a batch of one than for a larger batch; at the CIFG-LSTM's training
    shapes every batch from 2 to 19 gave each matrix the same bits on an
    H100 (``tests/test_torch_cuda.py`` holds a client's update bitwise
    across C)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"client_mm: expected (C, M, K) @ (C, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    C, M = a.shape[:2]
    if a.device.type != "cuda":
        mm = rowstable_mm if rows else torch.mm
        return torch.stack([mm(a[c], b[c]) for c in range(C)])
    if rows and M % ROW_TILE:
        a = torch.nn.functional.pad(a, (0, 0, 0, ROW_TILE - M % ROW_TILE))
    if C == 1:
        a, b = _widen(a), _widen(b)
    return torch.bmm(a, b)[:C, :M]
