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
bits whatever the chunk's width is and wherever the client sits
(`repro_torch.fl.client`). No library call may see a batch count that
depends on C: on an H100 a ``torch.bmm`` over the chunk moved a client's
bits with C where its rows were few (whisper-small's products at B 1), and
so did the attention and SSD backwards batched over C·B rows (at B 1 and
B 10). The zoo's products (`client_matmul`, `client_einsum`) are one call
a client (`per_client`), the call a one-client program makes; the
CIFG-LSTM's small float32 products (`client_mm`) are ``torch.bmm`` calls
of exactly ``CLIENT_TILE`` clients, the chunk padded with zeros; the
attention and SSD wrappers run their plain backwards a client at a time
(``clients=``). A per-client vector parameter (a norm scale, a bias, a
Mamba-2 ``D``, ``dt_bias``, ``A`` or conv tap) broadcasts over the
client's rows, and its gradient sums them: a CUDA sum's split depends on
how many sums the call makes, so `client_vector` and `client_rows` take
each client's sum alone. The rest of a chunk's program runs on the whole
chunk: every other step is elementwise or reduces within a row. On the
CPU, silu, gelu, softplus and exp compute a tensor's tail (past its last
pair of whole vectors) in scalar code, whose last bit can differ from the
vector code's; there `client_apply` runs them a client at a time. The card
computes every element alike.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F

from repro_torch.utils.spans import span

ROW_TILE = 256
CLIENT_TILE = 16

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
    M = a.shape[0]
    n_blocks = max(1, -(-M // ROW_TILE))
    with span("rowstable_mm", blocks=n_blocks):
        a = a.to(torch.float32)
        b = b.to(torch.float32)
        if M != n_blocks * ROW_TILE:
            padded = a.new_zeros((n_blocks * ROW_TILE, a.shape[1]))
            padded[:M] = a
            a = padded
        blocks = [torch.mm(a[i * ROW_TILE:(i + 1) * ROW_TILE], b)
                  for i in range(n_blocks)]
        out = blocks[0] if n_blocks == 1 else torch.cat(blocks)
        return out[:M]


def per_client(fn, *operands):
    """``fn`` of each client's operands (the leading axis C of every
    operand), stacked: client c's result is ``fn``'s one-client call on its
    own slices, the same bits whatever C is and wherever the client sits."""
    return torch.stack([fn(*ops) for ops in
                        zip(*(o.unbind(0) for o in operands))])


def client_mm(a: torch.Tensor, b: torch.Tensor, *, rows: bool = True
              ) -> torch.Tensor:
    """Per-client products ``a (C, M, K) @ b (C, K, N)`` in float32, the
    CIFG-LSTM's (small products, chunks of 16 to 32 clients). ``rows=True``
    pads each client's rows to a multiple of ``ROW_TILE`` first, as
    `rowstable_mm` does. On the CPU one product a client (`per_client`:
    `rowstable_mm`, or ``torch.mm`` for ``rows=False``). On CUDA the client
    axis is padded with zeros to a multiple of ``CLIENT_TILE`` and each
    block of ``CLIENT_TILE`` clients is one ``torch.bmm`` of the same
    shape, so no call's batch count depends on C (one call a chunk of 16,
    where C calls of their own would cost the LSTM's host-bound step a
    launch a client a product)."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[1]:
        raise ValueError(f"client_mm: expected (C, M, K) @ (C, K, N), got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    if a.device.type != "cuda":
        return per_client(rowstable_mm if rows else torch.mm, a, b)
    C, M = a.shape[:2]
    pad, row_pad = -C % CLIENT_TILE, -M % ROW_TILE if rows else 0
    # padded or not, both operands contiguous (a transposed view and an
    # expanded θ0 too), so that every call sees one layout
    if pad or row_pad:
        a = F.pad(a, (0, 0, 0, row_pad, 0, pad))
    if pad:
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
    a, b = a.contiguous(), b.contiguous()
    outs = [torch.bmm(a[i:i + CLIENT_TILE], b[i:i + CLIENT_TILE])
            for i in range(0, C + pad, CLIENT_TILE)]
    return (outs[0] if len(outs) == 1 else torch.cat(outs))[:C, :M]


def compute_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One client's ``x @ w`` in ``x``'s dtype, summed in float32: on the
    card one product in that dtype; on the CPU the product of the float32
    values, rounded once (the same arithmetic up to the order of the sum;
    the CPU's bfloat16 products are slow)."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def client_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`compute_mm` of each client (`per_client`): ``x (C, …, K) @
    w (C, K, N)`` → (C, …, N) in ``x``'s dtype."""
    if x.dim() < 2 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[-1] != w.shape[1]:
        raise ValueError(f"client_matmul: expected (C, …, K) @ (C, K, N), "
                         f"got {tuple(x.shape)} @ {tuple(w.shape)}")
    return per_client(compute_mm, x, w)


def compute_einsum(eq: str, a: torch.Tensor, b: torch.Tensor
                   ) -> torch.Tensor:
    """One client's ``torch.einsum(eq, a, b)`` in ``a``'s dtype, summed in
    float32: on the CPU the float32 product rounded once (as
    `compute_mm`)."""
    b = b.to(a.dtype)
    if a.device.type == "cpu" and a.dtype != torch.float32:
        return torch.einsum(eq, a.float(), b.float()).to(a.dtype)
    return torch.einsum(eq, a, b)


def client_einsum(eq: str, a: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """`compute_einsum` of each client (`per_client`), ``eq`` the
    one-client equation and both operands with a leading client axis."""
    return per_client(lambda x, y: compute_einsum(eq, x, y), a, b)


class _ClientApply(torch.autograd.Function):
    """``fn`` of each client's slice of x written into an output of x's
    layout; the backward is ``fn``'s gradient a client at a time."""

    @staticmethod
    def forward(ctx, fn, x):
        ctx.fn = fn
        ctx.save_for_backward(x)
        out = torch.empty_like(x)
        for c in range(x.shape[0]):
            out[c] = fn(x[c])
        return out

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        gx = torch.empty_like(x)
        for c in range(x.shape[0]):
            with torch.enable_grad():
                xc = x[c].detach().requires_grad_(True)
                gx[c] = torch.autograd.grad(ctx.fn(xc), xc, g[c])[0]
        return None, gx


def client_apply(fn, x: torch.Tensor, chunk: bool) -> torch.Tensor:
    """An elementwise ``fn`` (silu, gelu, softplus, exp) of activations
    ``x``; for a chunk (``x`` with a leading client axis) on the CPU one
    call a client, each client's elements in the vector or the scalar code
    as in its one-client call. Elsewhere one call."""
    if chunk and x.device.type == "cpu":
        return _ClientApply.apply(fn, x)
    return fn(x)


class _ClientVector(torch.autograd.Function):
    """(C, n) expanded to ``shape`` (C, …, n, …), the vector along axis
    ``dim``; the gradient is each client's sum over the rest, one
    reduction a client."""

    @staticmethod
    def forward(ctx, v, shape, dim):
        ctx.dim = dim
        view = v.reshape((v.shape[0],) + (1,) * (dim - 1) + (v.shape[-1],)
                         + (1,) * (len(shape) - 1 - dim))
        return view.expand(shape)

    @staticmethod
    def backward(ctx, g):
        dims = tuple(d for d in range(g.dim() - 1) if d != ctx.dim - 1)
        return torch.stack([gc.sum(dims) for gc in g.unbind(0)]), None, None


def client_vector(v: torch.Tensor, like: torch.Tensor, dim: int = -1
                  ) -> torch.Tensor:
    """A parameter vector against activations ``like``, along their axis
    ``dim``: one client's (n,) viewed to broadcast; a chunk's (C, n)
    expanded to ``like``'s shape (C, …), whose gradient sums each client's
    rows in a reduction of its own, the bits of the one-client broadcast's
    gradient whatever C is."""
    dim = dim % like.dim()
    if v.dim() == 1:
        return v.reshape((v.shape[0],) + (1,) * (like.dim() - 1 - dim))
    return _ClientVector.apply(v, tuple(like.shape), dim)


class _ClientRows(torch.autograd.Function):
    """(C, H) → (C·n, H), each client's row repeated for its n batch rows;
    the gradient sums each client's n rows alone."""

    @staticmethod
    def forward(ctx, A, n):
        ctx.n = n
        return A[:, None, :].expand(A.shape[0], n, A.shape[1]).reshape(
            -1, A.shape[1])

    @staticmethod
    def backward(ctx, g):
        return torch.stack([gc.sum(0) for gc in g.split(ctx.n)]), None


def client_rows(A: torch.Tensor, n: int) -> torch.Tensor:
    """One row of ``A`` per batch row: one client's (H,) expanded to (n, H)
    (a stride-0 view), a chunk's (C, H) to (C·n, H), client c's row on
    its n rows; each client's gradient is the sum over its own rows, as
    one client's expand sums them."""
    if A.dim() == 1:
        return A.expand(n, A.shape[0])
    return _ClientRows.apply(A, n)
