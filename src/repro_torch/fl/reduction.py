"""Canonical cohort reduction: the fixed association of the round's
clipped-update sum (the reference's ``fl/reduction.py``).

Float addition is not associative, so the order in which per-client
contributions are combined is part of the mechanism's contract. The
canonical order has two levels:

* across blocks — the padded cohort buffer is split into
  :data:`CANON_BLOCKS` contiguous blocks whose partials are combined by a
  fixed pairwise tree (:func:`fold_blocks`);
* across pods — on a ``(pod, data)`` layout each pod owns a contiguous
  group of blocks, folds it by the same tree, and only the pod partials
  are combined across pods (:func:`fold_pods`). :data:`CANON_BLOCKS` is a
  power of two, so a pod partial is an inner node of :func:`fold_blocks`'
  balanced tree and the two-level fold is bit-identical to the flat one
  for every pod count dividing the block count;
* within a block — slots are folded strictly left to right, one at a time
  (:func:`slot_fold`). A streaming accumulator that takes the block in
  contiguous chunks of any size reproduces that order exactly, so the sum
  is bit-identical for every ``cohort_chunk`` dividing the block size.

Masked slots contribute exactly zero: ``0·x ∈ {+0, −0}``, and adding a
signed zero to an accumulator that started at +0 changes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

CANON_BLOCKS = 8

# ceiling of the auto-selected cohort_chunk: the largest divisor of the
# block size not above it
DEFAULT_MAX_CHUNK = 32


def block_sums(a: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Sum contiguous equal blocks of the leading axis → (n_blocks, ...)
    (the materializing path's association)."""
    blk = a.shape[0] // n_blocks
    return a.reshape((n_blocks, blk) + tuple(a.shape[1:])).sum(dim=1)


def fold_blocks(a: torch.Tensor) -> torch.Tensor:
    """Fixed pairwise-adjacent tree combine over the leading axis."""
    while a.shape[0] > 1:
        half = a.shape[0] // 2
        c = a[0:2 * half:2] + a[1:2 * half:2]
        if a.shape[0] % 2:
            c = torch.cat([c, a[-1:]], dim=0)
        a = c
    return a[0]


def fold_pods(blocks: torch.Tensor, num_pods: int = 1) -> torch.Tensor:
    """Two-level fold over a ``(pod, data)`` layout: each pod's contiguous
    group of ``blocks.shape[0] / num_pods`` block partials by
    :func:`fold_blocks`' tree, then the pod partials by the same tree.
    Bit-identical to ``fold_blocks(blocks)`` for every power-of-two
    ``num_pods`` dividing a power-of-two block count."""
    if num_pods == 1:
        return fold_blocks(blocks)
    if num_pods < 1 or blocks.shape[0] % num_pods:
        raise ValueError(
            f"fold_pods: num_pods={num_pods} must divide the block count "
            f"{blocks.shape[0]} — each pod owns a contiguous group of whole "
            "canonical blocks (size the grid with n_canon_blocks(num_shards,"
            " num_pods))")
    per = blocks.shape[0] // num_pods
    return fold_blocks(torch.stack([fold_blocks(blocks[p * per:(p + 1) * per])
                                    for p in range(num_pods)]))


def slot_fold(acc, stacked):
    """Strict left-to-right sum of ``stacked``'s leading axis (a tree of
    tensors with a leading slot axis) into ``acc``."""
    n = tree_leaves(stacked)[0].shape[0]
    for i in range(n):
        acc = tree_map(lambda a, x: a + x[i], acc, stacked)
    return acc


def canon_pad(n: int, num_shards: int = 1, num_pods: int = 1) -> int:
    """Smallest padded cohort size ≥ ``n`` that splits into whole canonical
    blocks."""
    nb = n_canon_blocks(num_shards, num_pods)
    return -(-max(int(n), 1) // nb) * nb


def n_canon_blocks(num_shards: int = 1, num_pods: int = 1) -> int:
    """:data:`CANON_BLOCKS` when the total shard count divides it, else the
    next multiple of the total."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_pods < 1:
        raise ValueError(f"num_pods must be >= 1, got {num_pods}")
    total = num_shards * num_pods
    if CANON_BLOCKS % total == 0:
        return CANON_BLOCKS
    return total * max(1, -(-CANON_BLOCKS // total))


def auto_chunk(blk: int, max_chunk: int = DEFAULT_MAX_CHUNK) -> int:
    """Largest divisor of the block size ≤ ``max_chunk``."""
    for c in range(min(blk, max_chunk), 0, -1):
        if blk % c == 0:
            return c
    return 1


def resolve_chunk(cohort_chunk, blk: int, strict: bool = True) -> int:
    """``None`` → :func:`auto_chunk`; ``0`` → 0 (the materializing path);
    an explicit value must divide the block size, or with ``strict=False``
    is rounded down to the largest divisor not above it (the host loop's
    realized round size varies from round to round)."""
    if cohort_chunk is None:
        return auto_chunk(blk)
    c = int(cohort_chunk)
    if c == 0 or (c >= 1 and blk % c == 0):
        return c
    if not strict and c >= 1:
        return auto_chunk(blk, max_chunk=c)
    divisors = [d for d in range(1, blk + 1) if blk % d == 0]
    raise ValueError(
        f"cohort_chunk={cohort_chunk} must divide the canonical block "
        f"size {blk} (padded cohort / {CANON_BLOCKS} blocks) so chunk "
        f"boundaries stay inside block boundaries; valid values: "
        f"{divisors} (or None to auto-select, 0 for the materializing "
        "path)")


def cohort_sum(tree, mask, n_blocks: int = CANON_BLOCKS, num_pods: int = 1):
    """Masked sum over a stacked cohort tree (leading cohort axis; ``mask``
    the (C,) 0/1 slot mask) in the canonical order: block sums of the
    masked slots (the cohort zero-padded to whole blocks), then
    :func:`fold_pods`. Masked slots add exactly ±0."""
    m = torch.as_tensor(mask).to(torch.float32)
    pad = -(-m.shape[0] // n_blocks) * n_blocks - m.shape[0]

    def one(l):
        lm = l.to(torch.float32) * m.to(l.device).reshape(
            (-1,) + (1,) * (l.dim() - 1))
        if pad:
            lm = torch.cat([lm, lm.new_zeros((pad,) + tuple(lm.shape[1:]))])
        return fold_pods(block_sums(lm, n_blocks), num_pods)

    return tree_map(one, tree)
