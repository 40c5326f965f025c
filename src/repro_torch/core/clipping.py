"""Per-user update clipping (Algorithm 1, UserUpdate's final line).

``clip_by_global_norm`` is the plain tree path. ``clip_accumulate_tree`` is
the streaming form of the chunked cohort accumulator, one clip→fold step
``acc ← acc + scale·min(1, S/‖Δ‖)·Δ``, with two implementations:

* ``"fused"`` — the hand-written dp_clip kernels (`repro_torch.kernels.
  dp_clip`): one sum-of-squares launch over every leaf, which also forms
  the norm and the factor, and one scale-and-accumulate pass per leaf (the
  plain versions for CPU tensors);
* ``"tree"`` — plain tensor ops on :func:`clip_by_global_norm`'s arithmetic,
  the oracle the fused path is held against.

Both compute the pre-clip norm, the factor and the was-clipped flag with the
same formulas and differ only in the order of the sum of squares, so they
agree within float tolerance and each is deterministic on its own.
``clip_accumulate_chunk_tree`` is the fused step for a whole chunk of
clients, one sum-of-squares launch for the chunk and one accumulate launch
per leaf, with the bits of one ``clip_accumulate_tree`` per slot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dp_clip import ops as dp_clip_ops
from repro_torch.utils.pytree import tree_global_norm, tree_map

CLIP_PATHS = ("fused", "tree")


def clip_factor(norm, clip_norm: float) -> torch.Tensor:
    """min(1, S/‖Δ‖) — the paper's clip (Algorithm 1)."""
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-12), max=1.0)


def clip_by_global_norm(update, clip_norm: float):
    """Returns (clipped update, pre-clip norm, was_clipped)."""
    norm = tree_global_norm(update)
    factor = clip_factor(norm, clip_norm)
    clipped = tree_map(lambda l: (l.float() * factor).to(l.dtype), update)
    return clipped, norm, (factor < 1.0).float()


def clip_accumulate_tree(acc, update, clip_norm: float, scale=None, *,
                         clip_path: str = "fused"):
    """One streaming clip→accumulate step over float32 trees.

    ``scale`` (optional, a device scalar) carries the 0/1 slot mask, so a
    masked slot adds exactly ±0. Returns ``(new_acc, pre_clip_norm,
    was_clipped)``; the norm and flag describe the unmasked update (callers
    mask the stats themselves)."""
    if clip_path not in CLIP_PATHS:
        raise ValueError(f"clip_path must be one of {CLIP_PATHS}, "
                         f"got {clip_path!r}")
    if clip_path == "fused":
        new_acc, norm = dp_clip_ops.clip_accumulate(acc, update, clip_norm,
                                                    scale)
        factor = clip_factor(norm, clip_norm)
    else:
        norm = tree_global_norm(update)
        factor = clip_factor(norm, clip_norm)
        f = factor if scale is None else factor * scale
        new_acc = tree_map(lambda a, d: a + f * d.float(), acc, update)
    return new_acc, norm, (factor < 1.0).float()


def clip_accumulate_chunk_tree(acc, updates, clip_norm: float, scales):
    """The fused clip→fold of a chunk: ``updates`` (a list of float32 trees)
    folded into ``acc`` slot by slot, in order, ``scales`` the slots' device
    scalars (the 0/1 mask). Returns ``(new_acc, pre-clip norms,
    was-clipped flags)``, the last two lists in slot order."""
    new_acc, norms = dp_clip_ops.clip_accumulate_chunk(acc, updates,
                                                       clip_norm, scales)
    flags = (clip_factor(norms, clip_norm) < 1.0).float()
    return new_acc, list(norms.unbind()), list(flags.unbind())
