"""Nested-dict tensor helpers used across the DP machinery.

A tree is a nested ``dict`` whose leaves are tensors. Leaves are visited in
the order ``jax.tree_util`` uses for dicts — sorted keys, depth first — so
per-leaf reductions (the clip's sum of squares) add up in the reference's
order, and :func:`tree_noise` draws its leaves in that order too.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Dict:
    """``fn`` applied leaf by leaf over trees of one structure (keys sorted,
    as ``jax.tree_util.tree_map`` rebuilds them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_zeros_like(tree, dtype=None):
    return tree_map(lambda l: torch.zeros_like(l, dtype=dtype or l.dtype),
                    tree)


def tree_size(tree) -> int:
    return sum(l.numel() for l in tree_leaves(tree))


def tree_global_norm(tree) -> torch.Tensor:
    """Global L2 norm across every leaf (float32 sums, leaf by leaf in
    sorted-key order)."""
    sq = sum(torch.sum(torch.square(l.float())) for l in tree_leaves(tree))
    return torch.sqrt(sq)


def tree_noise(generator: torch.Generator, tree, std):
    """Gaussian noise matching ``tree``'s shapes, always float32, drawn from
    ``generator`` (which must live on the tree's device), leaf by leaf in
    sorted-key order.

    DP noise must be float32: at the paper's σ=3.2e-5 the perturbation is
    below bfloat16 resolution near typical weight scales and would round
    away."""
    return tree_map(lambda l: torch.randn(l.shape, generator=generator,
                                          dtype=torch.float32,
                                          device=l.device) * std, tree)


def tree_unflatten(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves``, given in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
