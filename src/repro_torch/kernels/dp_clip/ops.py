"""The dp_clip kernels' wrappers and the tree-level clip-and-accumulate.

``sumsq_chunk`` / ``sumsq`` and ``clip_accumulate_chunk_leaf`` wrap the CUDA
kernels of ``csrc/dp_clip.cu`` (which replace the Pallas ``sumsq`` and
``clip_accumulate_2d`` of the reference). They take float32 leaves of any
shape and length as they lie in memory: no (256, 128) tile padding, the
kernels mask the tail. ``sumsq_chunk(delta_trees, clip_norm, scales)`` takes
the sums of squares, norms and clip factors of up to :data:`MAX_CHUNK`
clients, all their leaves, in one launch; ``sumsq`` is its one-leaf call.
``clip_accumulate_chunk_leaf(acc, deltas, factors)`` folds up to
:data:`MAX_CHUNK` clients' deltas into ``acc`` in one launch, slot by slot;
``clip_accumulate_leaf`` is its one-client call. For tensors on the CPU they
compute the plain versions (`ref.py`); for CUDA tensors they launch their
kernel or raise. ``LAUNCHES[name]`` counts kernel launches only (a
``dp_sumsq`` launch is the wrapper's two CUDA kernels, one count).

``fused_sumsq(tree)`` and ``clip_accumulate(acc, delta, clip_norm, scale)``
have the contract of the reference's ``dp_clip/ops.py``: the global sum of
squares adds the per-leaf sums in sorted-key order, and the clip factor
``min(1, S/‖Δ‖)·scale`` stays a device scalar (reading it back would stop
the host once per client). ``scale`` carries a 0/1 slot mask, so a masked
slot adds exactly ±0. ``clip_accumulate_chunk`` is the same for a chunk of
clients: one ``sumsq_chunk`` launch, then one accumulate launch per leaf.
A client's sum of squares, norm and factor are the same bits whatever chunk
it sits in and wherever: the kernel's order is fixed by the leaf sizes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dp_clip.ref import (clip_accumulate_chunk_ref,
                                             sumsq_chunk_ref, sumsq_ref)
from repro_torch.utils.pytree import tree_leaves, tree_map

LAUNCHES = {"dp_sumsq": 0, "dp_clip_accumulate": 0}

# segments (stage-1 partials) of one leaf in dp_sumsq, at most (kMaxBlocks)
MAX_BLOCKS = 1024
# one dp_sumsq launch takes at most MAX_LEAVES leaves a client (a client
# with more takes one launch per MAX_LEAVES, carrying its sums) and MAX_PTRS
# leaves in all (kMaxLeaves, kMaxPtrs: the kernel's parameter)
MAX_LEAVES = 40
MAX_PTRS = 416
# clients one dp_sumsq or dp_clip_accumulate launch takes, at most
# (kMaxChunk)
MAX_CHUNK = 32


def _kernel(name: str):
    fn = getattr(build.load("dp_clip"), name)
    if fn.argtypes is None:
        p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = {"dp_sumsq": [p, n, p, p, p],
                       "dp_sumsq_chunk": [p, p, i, i, ctypes.c_float, p, p,
                                          p, n, p, p, p, p],
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


def _launch(name: str, dev, *args, counter: str | None = None) -> None:
    fn = _kernel(name)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[counter or name] += 1


def sumsq(x: torch.Tensor) -> torch.Tensor:
    """Σx² over a float32 leaf → a 0-dim float32 tensor on its device: the
    one-client, one-leaf call of `sumsq_chunk`'s kernels. On the card the sum
    runs in two fixed stages without atomics, so the same input gives the
    same bits on every run, and the bits `sumsq_chunk` adds for this leaf."""
    dev = _check_leaf("sumsq", x=x)
    if dev.type == "cpu":
        return sumsq_ref(x)
    partials = torch.empty((MAX_BLOCKS,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launch("dp_sumsq", dev, x.data_ptr(), x.numel(), partials.data_ptr(),
            out.data_ptr())
    return out


def sumsq_chunk(delta_trees, clip_norm: float, scales=None):
    """Every client's Σx², pre-clip norm and clip factor for a chunk of
    float32 trees of one structure → (ss, norms, factors), each (C,) float32
    on their device.

    ``ss[c]`` adds the per-leaf sums of squares in sorted-key order starting
    from +0.0, as :func:`fused_sumsq` does; ``norms = sqrt(ss)``;
    ``factors[c] = min(1, S / max(norm, 1e-12)) · scales[c]`` with the
    arithmetic of ``clip_factor`` (``scales``: one device scalar or None per
    slot, the 0/1 mask; None is no mask). On the card this is one launch per
    :data:`MAX_CHUNK` clients (at most :data:`MAX_PTRS` leaves in all) and
    :data:`MAX_LEAVES` leaves, the later launches starting from the sums
    the earlier left; a client's three values are the bits of
    :func:`fused_sumsq` + ``clip_factor`` whatever chunk it is in and
    wherever."""
    leaves = [tree_leaves(t) for t in delta_trees]
    C = len(leaves)
    if C < 1 or not leaves[0]:
        raise ValueError("sumsq_chunk: needs at least one client and leaf")
    L = len(leaves[0])
    sizes = [x.numel() for x in leaves[0]]
    for c, ls in enumerate(leaves):
        if [x.numel() for x in ls] != sizes:
            raise ValueError(f"sumsq_chunk: client {c}'s leaves "
                             f"{[x.numel() for x in ls]} differ from client "
                             f"0's {sizes}")
    dev = _check_leaf("sumsq_chunk", **{f"client {c} leaf {l}": x
                                        for c, ls in enumerate(leaves)
                                        for l, x in enumerate(ls)})
    scales = [None] * C if scales is None else list(scales)
    if len(scales) != C:
        raise ValueError(f"sumsq_chunk: {len(scales)} scales for {C} clients")
    sc = None
    if any(s is not None for s in scales):
        sc = torch.stack([torch.as_tensor(1.0 if s is None else s,
                                          dtype=torch.float32,
                                          device=dev).reshape(())
                          for s in scales])
    if dev.type == "cpu":
        return sumsq_chunk_ref(leaves, clip_norm, sc)
    Lg = min(L, MAX_LEAVES)
    per = min(MAX_CHUNK, MAX_PTRS // Lg)
    ss, norms, factors = (torch.empty((C,), dtype=torch.float32, device=dev)
                          for _ in range(3))
    partials = torch.empty((min(per, C) * Lg * MAX_BLOCKS,),
                           dtype=torch.float32, device=dev)

    def at(t, c0):                  # slot c0 of a (C,) tensor, or None
        return None if t is None else t.data_ptr() + 4 * c0

    for c0 in range(0, C, per):
        group = leaves[c0:c0 + per]
        for l0 in range(0, L, Lg):
            n = min(Lg, L - l0)
            last = l0 + n == L
            sizes_arr = (ctypes.c_longlong * n)(*sizes[l0:l0 + n])
            ptrs = (ctypes.c_void_p * (len(group) * n))(
                *(x.data_ptr() for ls in group for x in ls[l0:l0 + n]))
            _launch("dp_sumsq_chunk", dev, ctypes.addressof(ptrs),
                    ctypes.addressof(sizes_arr), len(group), n, clip_norm,
                    at(sc, c0), at(ss, c0) if l0 else None,
                    partials.data_ptr(), partials.numel(), at(ss, c0),
                    at(norms, c0) if last else None,
                    at(factors, c0) if last else None, counter="dp_sumsq")
    return ss, norms, factors


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
    order: every slot's sum of squares, norm and factor first (one
    :func:`sumsq_chunk`), then one accumulate launch per leaf for each run
    of up to :data:`MAX_CHUNK` slots. ``scales`` (one device scalar or None
    per slot) carries the 0/1 slot mask. Returns (new acc tree, pre-clip
    norms (C,)); the sum has the bits of one :func:`clip_accumulate` per
    slot."""
    delta_trees = list(delta_trees)
    _, norms, factors = sumsq_chunk(delta_trees, clip_norm, scales)
    for c0 in range(0, len(delta_trees), MAX_CHUNK):
        group = delta_trees[c0:c0 + MAX_CHUNK]
        f = factors[c0:c0 + MAX_CHUNK]
        acc_tree = tree_map(
            lambda a, *ds: clip_accumulate_chunk_leaf(a, ds, f), acc_tree,
            *group)
    return acc_tree, norms
