"""The dp_clip kernels' wrappers and the tree-level clip-and-accumulate.

``sumsq`` and ``clip_accumulate_leaf`` wrap the two CUDA kernels of
``csrc/dp_clip.cu`` (which replace the Pallas ``sumsq`` and
``clip_accumulate_2d`` of the reference). They take a float32 leaf of any
shape and length as it lies in memory: no (256, 128) tile padding, the
kernels mask the tail. For tensors on the CPU they compute the plain
versions (`ref.py`); for CUDA tensors they launch their kernel or raise.
``LAUNCHES[name]`` counts kernel launches only.

``fused_sumsq(tree)`` and ``clip_accumulate(acc, delta, clip_norm, scale)``
have the contract of the reference's ``dp_clip/ops.py``: the global sum of
squares adds the per-leaf sums in sorted-key order, and the clip factor
``min(1, S/‖Δ‖)·scale`` stays a device scalar (reading it back would stop
the host once per client). ``scale`` carries a 0/1 slot mask, so a masked
slot adds exactly ±0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_clip.ref import (clip_accumulate_ref,
                                             clip_factor_ref, sumsq_ref)
from repro_torch.utils.pytree import tree_leaves, tree_map

LAUNCHES = {"dp_sumsq": 0, "dp_clip_accumulate": 0}

# stage-1 partials of dp_sumsq: at most this many (kMaxBlocks in the source)
MAX_BLOCKS = 1024


def _kernel(name: str):
    fn = getattr(build.load("dp_clip"), name)
    if fn.argtypes is None:
        p, n = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = {"dp_sumsq": [p, n, p, p, p],
                       "dp_clip_accumulate": [p, p, p, p, n, p]}[name]
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


def clip_accumulate_leaf(acc: torch.Tensor, delta: torch.Tensor,
                         factor: torch.Tensor) -> torch.Tensor:
    """acc + factor·delta → a new float32 tensor; ``factor`` a 0-dim float32
    tensor on the leaves' device. The product and the sum are rounded
    separately (no fused multiply-add), as in the plain version."""
    factor = torch.as_tensor(factor, dtype=torch.float32,
                             device=acc.device).reshape(())
    dev = _check_leaf("clip_accumulate", acc=acc, delta=delta, factor=factor)
    if acc.shape != delta.shape:
        raise ValueError(f"clip_accumulate: acc {tuple(acc.shape)} and delta "
                         f"{tuple(delta.shape)} differ in shape")
    if dev.type == "cpu":
        return clip_accumulate_ref(acc, delta, factor)
    out = torch.empty_like(acc)
    _launch("dp_clip_accumulate", dev, acc.data_ptr(), delta.data_ptr(),
            factor.data_ptr(), out.data_ptr(), acc.numel())
    return out


def fused_sumsq(tree) -> torch.Tensor:
    """Global Σx² over a tree: one `sumsq` per leaf, added in sorted-key
    order."""
    return sum(sumsq(l) for l in tree_leaves(tree))


def clip_accumulate(acc_tree, delta_tree, clip_norm: float, scale=None):
    """acc ← acc + scale·min(1, S/‖Δ‖)·Δ (Algorithm 1's clip and round sum),
    leaf by leaf through the kernels. Returns (new acc tree, pre-clip norm
    ‖Δ‖), both on the device."""
    ss = fused_sumsq(delta_tree)
    factor = clip_factor_ref(ss, clip_norm)
    if scale is not None:
        factor = factor * scale
    new_acc = tree_map(lambda a, d: clip_accumulate_leaf(a, d, factor),
                       acc_tree, delta_tree)
    return new_acc, torch.sqrt(ss)
