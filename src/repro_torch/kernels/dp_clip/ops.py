"""The dp_clip kernels' wrappers and the tree-level clip-and-accumulate.

``sumsq`` and ``clip_accumulate_chunk_leaf`` wrap the two CUDA kernels of
``csrc/dp_clip.cu`` (which replace the Pallas ``sumsq`` and
``clip_accumulate_2d`` of the reference). They take float32 leaves of any
shape and length as they lie in memory: no (256, 128) tile padding, the
kernels mask the tail. ``clip_accumulate_chunk_leaf(acc, deltas, factors)``
folds up to :data:`MAX_CHUNK` clients' deltas into ``acc`` in one launch,
slot by slot; ``clip_accumulate_leaf`` is its one-client call. For tensors on
the CPU they compute the plain versions (`ref.py`); for CUDA tensors they
launch their kernel or raise. ``LAUNCHES[name]`` counts kernel launches
only.

``fused_sumsq(tree)`` and ``clip_accumulate(acc, delta, clip_norm, scale)``
have the contract of the reference's ``dp_clip/ops.py``: the global sum of
squares adds the per-leaf sums in sorted-key order, and the clip factor
``min(1, S/‖Δ‖)·scale`` stays a device scalar (reading it back would stop
the host once per client). ``scale`` carries a 0/1 slot mask, so a masked
slot adds exactly ±0. ``clip_accumulate_chunk`` is the same for a chunk of
clients, with one accumulate launch per leaf.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_clip.ref import (clip_accumulate_chunk_ref,
                                             clip_factor_ref, sumsq_ref)
from repro_torch.utils.pytree import tree_leaves, tree_map

LAUNCHES = {"dp_sumsq": 0, "dp_clip_accumulate": 0}

# stage-1 partials of dp_sumsq: at most this many (kMaxBlocks in the source)
MAX_BLOCKS = 1024
# clients one dp_clip_accumulate launch folds, at most (kMaxChunk)
MAX_CHUNK = 32


def _kernel(name: str):
    fn = getattr(build.load("dp_clip"), name)
    if fn.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {"dp_sumsq": [p, n, p, p, p],
                       "dp_clip_accumulate": [p, p, p, p, i, n, p]}[name]
        fn.restype = ctypes.c_int
    return fn


def _check_leaf(name: str, **tensors) -> torch.device:
    """float32, one device, contiguous on CUDA; returns the device."""
    dev = next(iter(tensors.values())).device
    for tname, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {tname} must be float32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {tname} is on {t.device}, not {dev}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name: str, dev, *args) -> None:
    fn = _kernel(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """Σx² over a float32 leaf → a 0-dim float32 tensor on its device. On
    the card the sum runs in two fixed stages without atomics, so the same
    input gives the same bits on every run."""
    dev = _check_leaf("sumsq", x=x)
    if dev.type == "cpu":
        return sumsq_ref(x)
    partials = torch.empty((MAX_BLOCKS,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launch("dp_sumsq", dev, x.data_ptr(), x.numel(), partials.data_ptr(),
            out.data_ptr())
    return out


def clip_accumulate_chunk_leaf(acc: torch.Tensor, deltas,
                               factors: torch.Tensor, *, out=None
                               ) -> torch.Tensor:
    """(((acc + f₀·Δ₀) + f₁·Δ₁) + …) over the C = len(deltas) slots, in
    order, 1 ≤ C ≤ :data:`MAX_CHUNK` → a new float32 tensor (or ``out``,
    which may be ``acc`` itself). ``deltas`` are float32 tensors of acc's
    shape; ``factors`` a (C,) float32 tensor on their device. Every step is
    a rounded product then a rounded sum (no fused multiply-add), as in the
    plain version, so one launch gives the bits of C one-client launches."""
    deltas = list(deltas)
    C = len(deltas)
    if not 1 <= C <= MAX_CHUNK:
        raise ValueError(f"clip_accumulate: a chunk holds 1 to {MAX_CHUNK} "
                         f"clients, got {C}")
    named = {"acc": acc, "factors": factors,
             **{f"deltas[{c}]": d for c, d in enumerate(deltas)}}
    if out is not None:
        named["out"] = out
    dev = _check_leaf("clip_accumulate", **named)
    for name, t in named.items():
        if name != "factors" and t.shape != acc.shape:
            raise ValueError(f"clip_accumulate: {name} {tuple(t.shape)} and "
                             f"acc {tuple(acc.shape)} differ in shape")
    if factors.shape != (C,):
        raise ValueError(f"clip_accumulate: factors must be ({C},), got "
                         f"{tuple(factors.shape)}")
    if dev.type == "cpu":
        res = clip_accumulate_chunk_ref(acc, deltas, factors)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty_like(acc)
    ptrs = (ctypes.c_void_p * C)(*(d.data_ptr() for d in deltas))
    _launch("dp_clip_accumulate", dev, acc.data_ptr(), ctypes.addressof(ptrs),
            factors.data_ptr(), out.data_ptr(), C, acc.numel())
    return out


def clip_accumulate_leaf(acc: torch.Tensor, delta: torch.Tensor,
                         factor: torch.Tensor) -> torch.Tensor:
    """acc + factor·delta → a new float32 tensor; ``factor`` a 0-dim float32
    tensor on the leaves' device: the one-client call of
    :func:`clip_accumulate_chunk_leaf`."""
    factor = torch.as_tensor(factor, dtype=torch.float32,
                             device=acc.device).reshape(1)
    return clip_accumulate_chunk_leaf(acc, [delta], factor)


def fused_sumsq(tree) -> torch.Tensor:
    """Global Σx² over a tree: one `sumsq` per leaf, added in sorted-key
    order."""
    return sum(sumsq(l) for l in tree_leaves(tree))


def clip_accumulate(acc_tree, delta_tree, clip_norm: float, scale=None):
    """acc ← acc + scale·min(1, S/‖Δ‖)·Δ (Algorithm 1's clip and round sum),
    leaf by leaf through the kernels. Returns (new acc tree, pre-clip norm
    ‖Δ‖), both on the device."""
    new_acc, norms = clip_accumulate_chunk(acc_tree, [delta_tree], clip_norm,
                                           [scale])
    return new_acc, norms[0]


def clip_accumulate_chunk(acc_tree, delta_trees, clip_norm: float, scales):
    """:func:`clip_accumulate` for a chunk of clients, folded slot by slot in
    order: every slot's sum of squares and factor first (one `fused_sumsq`
    each), then one accumulate launch per leaf for each run of up to
    :data:`MAX_CHUNK` slots. ``scales`` (one device scalar or None per slot)
    carries the 0/1 slot mask. Returns (new acc tree, list of pre-clip
    norms); the sum has the bits of one :func:`clip_accumulate` per slot."""
    delta_trees = list(delta_trees)
    factors = []
    norms = []
    for delta, scale in zip(delta_trees, scales, strict=True):
        ss = fused_sumsq(delta)
        factor = clip_factor_ref(ss, clip_norm)
        factors.append(factor if scale is None else factor * scale)
        norms.append(torch.sqrt(ss))
    for c0 in range(0, len(delta_trees), MAX_CHUNK):
        group = delta_trees[c0:c0 + MAX_CHUNK]
        f = torch.stack(factors[c0:c0 + MAX_CHUNK])
        acc_tree = tree_map(
            lambda a, *ds: clip_accumulate_chunk_leaf(a, ds, f), acc_tree,
            *group)
    return acc_tree, norms
