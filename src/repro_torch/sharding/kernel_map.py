"""The hand-written kernels under DTensor.

A kernel's wrapper launches it through ``ctypes`` on the storage of plain
tensors, so it cannot take a DTensor. Where the production step
(`repro_torch.launch.steps`) runs a model on DTensors over the ``model``
axis, each call site that reaches a kernel hands the wrapper every rank's
local shard through ``torch.distributed.tensor.experimental.local_map``:
the inputs are first redistributed to the placements the kernel takes,
the wrapper runs on the local tensors (its CUDA kernel for CUDA tensors,
its plain version on the CPU), and its outputs come back as DTensors.
``local_map``'s inputs and outputs are differentiable, so the kernels'
gradients (`repro_torch.kernels.recompute`, the CIFG backward kernel) flow
through it unchanged.

What each kernel takes over a mesh axis of n ranks:

* flash attention (:func:`attention_heads`): the heads dim ``Shard`` when
  the query heads divide n, each rank attending its own heads; KV heads
  that do not divide n are repeated to the query heads first, so a rank's
  query heads meet their own KV heads (the reference reshards at the
  reshape to heads); ``Replicate`` when the query heads do not divide n;
* the SSD scan: the SSM heads ``Shard`` when they divide n, else
  ``Replicate``;
* the CIFG recurrence: ``Replicate`` (its 3H gate columns interleave the
  units, so no split of them is a split of the units).

The decode step's in-place cache write (:func:`cache_write`) is local
too: DTensor's rule for ``index_copy_`` into a sequence-sharded cache
relabels the cache replicated without gathering it.

Off a mesh every function here is the plain call.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

__all__ = ["attention_heads", "cache_write", "is_dtensor", "map_local"]


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def map_local(fn: Callable, args: Sequence, dims: Sequence[Optional[int]],
              out_dims: Union[Optional[int], Tuple[Optional[int], ...]], *,
              shard: bool):
    """``fn(*args)`` on every rank's local tensors of a 1-D mesh. With
    ``shard``, DTensor argument ``i`` is split on dim ``dims[i]`` (``None``:
    replicated) and output ``j`` comes back split on ``out_dims[j]``;
    without it everything is replicated. ``out_dims`` is one entry for a
    single output, a tuple for several. Plain arguments pass as they
    are."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    if mesh.ndim != 1:
        raise ValueError(f"map_local takes a 1-D mesh (the model axis), got "
                         f"{mesh.ndim} dims {mesh.mesh_dim_names}")

    def pl(d):   # a list: local_map reads a tuple as one entry per output
        return [Shard(d)] if shard and d is not None else [Replicate()]

    in_pl = tuple(pl(d) if is_dtensor(a) else None
                  for a, d in zip(args, dims))
    out_pl = (tuple(pl(d) for d in out_dims) if isinstance(out_dims, tuple)
              else pl(out_dims))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _repeat_heads(t, g: int):
    """(B, S, KV, hd) → (B, S, KV·g, hd), each KV head repeated for its g
    query heads (replicated over the mesh)."""
    return map_local(lambda x: x.repeat_interleave(g, dim=2), (t,), (None,),
                     None, shard=False)


def attention_heads(fn: Callable, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` — attention over (B, S, heads, hd) tensors,
    ``extra`` replicated (positions, lengths) — on the local heads of
    DTensor inputs over the model axis."""
    n = q.device_mesh.size()
    H, KV = q.shape[2], k.shape[2]
    rest = (None,) * len(extra)
    if H % n:
        return map_local(fn, (q, k, v) + extra, (None, None, None) + rest,
                         None, shard=False)
    if KV % n:
        k, v = _repeat_heads(k, H // KV), _repeat_heads(v, H // KV)
    return map_local(fn, (q, k, v) + extra, (2, 2, 2) + rest, 2, shard=True)


def cache_write(cache, slot, new) -> None:
    """``cache[:, slot] = new`` in place: cache (B, T, KV, hd), slot (1,)
    int64, new (B, 1, KV, hd). A DTensor cache over the model axis is
    written in each rank's local storage: in its own heads (or whole) as it
    is laid out, and a cache sharded on T only by the rank that holds the
    slot (the others write their own value back)."""
    if not is_dtensor(cache):
        cache.index_copy_(1, slot, new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = cache.device_mesh
    (pl,) = cache.placements
    local = cache.to_local()
    slot = slot.to_local() if is_dtensor(slot) else slot
    if isinstance(pl, Shard) and pl.dim == 1:
        n = local.shape[1]
        at = slot - mesh.get_local_rank(0) * n
        mine = (at >= 0) & (at < n)
        at = at.clamp(0, n - 1)
        val = new.redistribute(mesh, [Replicate()]).to_local()
        val = torch.where(mine, val.to(local.dtype),
                          local.index_select(1, at))
        local.index_copy_(1, at, val)
        return
    local.index_copy_(1, slot, new.redistribute(mesh, [pl]).to_local()
                      .to(local.dtype))
