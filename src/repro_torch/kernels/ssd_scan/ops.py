"""The SSD scan kernel's wrapper (the reference's ``ssd_scan/ops.py``).

``ssd_scan(x, dt, Bm, Cm, A)`` computes the Mamba-2 chunked scan from a zero
state: ``y`` (B,S,H,p) and the final state (B,H,p,N), both float32. ``A``
is (H,), shared by every batch row as in the reference, or (B, H), one row
each: a chunk of clients folded into the batch, each client's
``A = −exp(A_log)`` on its own rows. A (B, H) ``A`` whose batch stride is 0
(an ``expand`` of one row) is the shared form: the kernel reads one row
(``a_stride`` 0), bitwise the (H,) call. Like the reference it pads S to a
multiple of ``CHUNK`` with dt = 0, which makes the padding an identity step
of the recurrence, and computes in float32. For
tensors on the CPU it computes the plain chunked form (`ref.ssd_chunked`)
on float32 casts; for CUDA tensors it runs ``csrc/ssd_scan.cu`` or raises.
The kernel reads x, Bm and Cm in bfloat16 when all three are bfloat16 (as
the hybrid model gives them) and converts them in registers, which is
exact: the result is bitwise that of their float32 casts. Any p and N are
taken: above 128 the kernel's wide route cuts them into slices. One call
runs the kernel's three CUDA kernels (chunk states, the pass over the
chunks, the chunk scan) and counts one in ``LAUNCHES["ssd_scan"]``.

On CUDA tensors both outputs are differentiable: the launch runs inside
`repro_torch.kernels.recompute.RecomputeGrad`, whose backward is the
gradient of the plain chunked form (`ssd_scan_plain`) recomputed from the
saved, padded inputs (the reference trains through ``ssd_chunked``, which
XLA differentiates; there is no TPU backward kernel). The final state's
incoming gradient may be ``None``. The backward launches nothing, so the
counter counts forward launches only.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.recompute import RecomputeGrad, by_client
from repro_torch.kernels.ssd_scan.ref import CHUNK, ssd_chunked

LAUNCHES = {"ssd_scan": 0}


def _kernel():
    fn = build.load("ssd_scan").ssd_scan_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 9 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, dt, Bm, Cm, A):
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B,S,H,p), got "
                         f"{tuple(x.shape)}")
    Bsz, S, H, p = x.shape
    N = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (Bsz, S, H), "Bm": (Bsz, S, N), "Cm": (Bsz, S, N),
            "A": (Bsz, H) if A.dim() == 2 else (H,)}
    for name, t in (("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssd_scan: expected {name} {want[name]} for x "
                             f"{tuple(x.shape)}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is on {t.device}, x on "
                             f"{x.device}")
    for name, t in (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A)):
        if not t.is_floating_point():
            raise TypeError(f"ssd_scan: {name} must be floating point, got "
                            f"{t.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    return Bsz, S, H, p, N


def ssd_scan(x, dt, Bm, Cm, A, *, clients: int = 1):
    """x: (B,S,H,p); dt: (B,S,H); Bm, Cm: (B,S,N); A: (H,) or (B,H)
    negative. Returns (y (B,S,H,p) float32, final state (B,H,p,N)
    float32), on CUDA tensors differentiable through the plain version's
    gradient. ``clients``: the batch folds a chunk of that many clients'
    rows (``A`` (B, H)), one launch for all, and the plain version runs a
    client at a time (`recompute.by_client`)."""
    _check(x, dt, Bm, Cm, A)
    if x.shape[0] % clients or (clients > 1 and A.dim() != 2):
        raise ValueError(f"ssd_scan: {x.shape[0]} batch rows with A "
                         f"{tuple(A.shape)} do not fold {clients} clients")
    plain = by_client(ssd_scan_plain, clients)
    S = x.shape[1]
    pad = (-S) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))    # dt = 0: identity on the padding
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    if x.device.type == "cpu":
        y, state = plain(x, dt, Bm, Cm, A)
    else:
        y, state = RecomputeGrad.apply(_launch, plain, x, dt, Bm, Cm, A)
    return (y[:, :S] if pad else y), state


def ssd_scan_plain(x, dt, Bm, Cm, A):
    """The plain chunked form on float32 casts of inputs padded to a
    multiple of ``CHUNK``, from a zero state: the CPU path of `ssd_scan`
    and the gradient of its kernel."""
    Bsz, _, H, p = x.shape
    h0 = torch.zeros((Bsz, H, p, Bm.shape[-1]), dtype=torch.float32,
                     device=x.device)
    return ssd_chunked(x.float(), dt.float(), Bm.float(), Cm.float(),
                       A.float(), h0)


def _launch(x, dt, Bm, Cm, A):
    """One call of the kernel (three CUDA kernels) on checked CUDA tensors
    padded to a multiple of ``CHUNK``, counted once."""
    Bsz, Sp, H, p = x.shape
    N = Bm.shape[-1]
    io = (torch.bfloat16 if x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
          else torch.float32)
    x, Bm, Cm = (t.to(io).contiguous() for t in (x, Bm, Cm))
    if A.dim() == 2 and A.stride(0) == 0:
        A = A[0]                       # one row, expanded: the shared form
    a_stride = H if A.dim() == 2 else 0
    dt, A = (t.float().contiguous() for t in (dt, A))
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, p, N), dtype=torch.float32, device=x.device)
    chunk_states = torch.empty((Bsz, Sp // CHUNK, H, p, N),
                               dtype=torch.float32, device=x.device)
    decay = torch.empty((Bsz, Sp // CHUNK, H), dtype=torch.float32,
                        device=x.device)
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 A.data_ptr(), y.data_ptr(), state.data_ptr(),
                 chunk_states.data_ptr(), decay.data_ptr(),
                 int(io == torch.bfloat16), Bsz, Sp, H, p, N, a_stride,
                 stream)
    if err != 0:   # 1 (invalid value): a shape the kernel does not take
        raise RuntimeError(f"ssd_scan kernel launch failed with CUDA error "
                           f"{err} (B={Bsz}, S={Sp}, H={H}, p={p}, N={N}; "
                           f"the kernel takes B <= 65535 and S / 128 <= "
                           f"65535)")
    LAUNCHES["ssd_scan"] += 1
    return y, state
