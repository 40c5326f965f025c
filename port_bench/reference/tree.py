"""Nested dicts of tensors, visited in sorted-key order, depth first."""
from __future__ import annotations

from typing import Callable, List, Tuple


def leaves(tree) -> List:
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in leaves(tree[k])]
    return [tree]


def paths(tree, prefix: str = "") -> List[str]:
    """The leaves' names, ``a/b/c``, in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def tmap(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tmap(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def unflatten(tree, new_leaves) -> dict:
    it = iter(new_leaves)
    return tmap(lambda _: next(it), tree)


def shapes(tree) -> List[Tuple[int, ...]]:
    return [tuple(l.shape) for l in leaves(tree)]
