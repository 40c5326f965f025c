"""The block-keyed population sampler on one device (the single-device part
of the reference's ``fl/pop_sampler.py``): block-local Gumbel top-k.

The engine's ``sampler="global"`` draws one availability uniform per user
from the training generator and selects the cohort with
``torch.multinomial`` over all N users. ``sampler="sharded"`` lays the
population axis out in canonical blocks, draws every per-user uniform from
a **block-keyed** stream, and selects by an exact Gumbel **top-k**. Three
rules fix its result, as in the reference:

* **block-keyed draws** — the padded population (:func:`pop_pad` rows)
  splits into :func:`n_pop_blocks` equal contiguous blocks; block ``b``'s
  uniforms come from a generator of its own, seeded from (seed, round,
  stream, b) (:func:`block_seed`, the counterpart of the reference's
  ``fold_in(key, b)``), never from a draw shaped like the population. So
  the draws do not depend on how blocks are grouped, and they do not touch
  the engine's training generator;
* **total-order selection** — a user's rank is the pair (score descending,
  user id ascending), the float32 score mapped to order-preserving int32
  bits (:func:`sortable_f32`). ``torch.topk`` promises no order among equal
  values, so the pair becomes one unique int64 key
  (``sortable_f32(score) << 32 | (2³¹−1 − uid)``, :func:`lex_key`): the top
  k of unique keys is a unique set in a unique order, bitwise the
  reference's ``lax.top_k`` with its lowest-index-first ties;
* **index-order Poisson packing** — a Poisson round's buffer holds the
  first ``buffer`` selected users in index order (:func:`pack_selected`,
  :func:`merge_poisson`).

Population-vector updates (``last_round`` / ``participation``) are
O(cohort) masked scatters (:func:`scatter_max`, :func:`scatter_add`).

Over T ranks (`repro_torch.launch.mesh`), rank :func:`shard_rank` owns a
contiguous group of whole population blocks. It draws its blocks'
uniforms, takes the top candidates of its rows (:func:`blocked_topk`) or
packs its selected rows (:func:`pack_selected`), and
:func:`gather_shards` gives every rank the pod-major concatenation of all
ranks' candidates, which each merges the same way (:func:`merge_topk`,
:func:`merge_poisson`). The K best under a total order are contained in
the union of each rank's K best, and a rank's packed list is in index
order, so the merged cohort is bitwise the one-rank cohort, on every
topology. One rank takes the same steps, with nothing to gather.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fl.reduction import canon_pad, n_canon_blocks
from repro_torch.launch.mesh import all_gather_copies

__all__ = ["INT32_MAX", "INT32_MIN", "STREAMS", "block_gumbels",
           "block_seed", "block_uniforms", "blocked_topk", "gather_shards",
           "lex_key", "merge_poisson", "merge_topk", "n_pop_blocks",
           "pack_selected", "pop_pad", "scatter_add", "scatter_max",
           "shard_rank", "sortable_f32"]

# Sort key of padded (beyond n_users) rows: below every real score's key
# (even -inf maps above it), so padding is never selected while
# cohort <= n_users.
INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1

# the block-keyed streams of a round: availability, and the cohort draw
# (Gumbel scores of fixed rounds, Bernoulli uniforms of Poisson rounds)
STREAMS = {"available": 0, "sample": 1}


def pop_pad(n_users: int, num_shards: int = 1, num_pods: int = 1) -> int:
    """Padded population length: the smallest multiple of the population
    block count ≥ ``n_users`` (the cohort buffer's `reduction.canon_pad`
    rule applied to users)."""
    return canon_pad(n_users, num_shards, num_pods)


def n_pop_blocks(num_shards: int = 1, num_pods: int = 1) -> int:
    """Population block count — `reduction.n_canon_blocks` on the user
    axis."""
    return n_canon_blocks(num_shards, num_pods)


def shard_rank(mesh) -> int:
    """Pod-major linear rank on a cohort ``DeviceMesh``
    (`launch.mesh.make_cohort_mesh`), from its mesh coordinates: rank ``r``
    owns population rows ``[r·n_loc, (r+1)·n_loc)``."""
    coord = mesh.get_coordinate()
    if len(coord) == 1:
        return int(coord[0])
    return int(coord[0]) * mesh.size(1) + int(coord[1])


def gather_shards(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's candidate array, gathered over the ``data`` group and
    then the ``pod`` group into the pod-major concatenation: (k, ...)
    local → (T·k, ...), rank ``r``'s slice at ``[r·k, (r+1)·k)``. Carries
    raw candidates only, so every rank merges the identical list."""
    g = all_gather_copies(x, mesh.get_group("data"))
    if mesh.ndim == 2:
        g = all_gather_copies(g, mesh.get_group("pod"))
    return g


def block_seed(seed: int, round_idx: int, stream: int, block: int) -> int:
    """The seed of one block's generator in one round and stream."""
    state = np.random.SeedSequence([int(seed), int(round_idx), int(stream),
                                    int(block)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def block_uniforms(generator: torch.Generator, seed: int, round_idx: int,
                   stream: int, block_ids, blk: int) -> torch.Tensor:
    """(len(block_ids), blk) float32 uniforms in [0, 1) on ``generator``'s
    device, block ``b`` from ``generator`` reseeded with
    :func:`block_seed` ``(seed, round_idx, stream, b)``. The seed and offset
    are taken when each draw is launched, so one generator object serves
    every block."""
    dev = generator.device
    out = torch.empty((len(block_ids), blk), dtype=torch.float32, device=dev)
    for i, b in enumerate(block_ids):
        generator.manual_seed(block_seed(seed, round_idx, stream, int(b)))
        torch.rand((blk,), generator=generator, device=dev, out=out[i])
    return out


def block_gumbels(generator: torch.Generator, seed: int, round_idx: int,
                  block_ids, blk: int) -> torch.Tensor:
    """(len(block_ids), blk) standard Gumbel draws −log(−log u) from the
    ``sample`` stream's block uniforms, u kept ≥ the smallest normal float
    (as the reference's ``jax.random.gumbel`` keeps it)."""
    u = block_uniforms(generator, seed, round_idx, STREAMS["sample"],
                       block_ids, blk)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sortable_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 preserving order (``a < b ⟺ s(a) < s(b)`` as signed
    ints) for every finite value and ±inf: the float's bits viewed as
    int32, negative values' magnitude bits flipped (``~u``) and re-centred
    (``^ INT32_MIN``). −0.0 maps one below +0.0."""
    u = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.where(u < 0, torch.bitwise_xor(torch.bitwise_not(u),
                                                INT32_MIN), u)


def lex_key(skey: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One int64 key per (int32 sort key, id < 2³¹) pair whose descending
    order is (``skey`` descending, ``ids`` ascending): unique whenever the
    ids are."""
    return (skey.to(torch.int64) << 32) | (INT32_MAX - ids.to(torch.int64))


def _unkey(keys: torch.Tensor):
    """(int32 sort keys, int64 ids) back from :func:`lex_key` keys."""
    return ((keys >> 32).to(torch.int32),
            INT32_MAX - (keys & 0xFFFFFFFF))


def blocked_topk(skey: torch.Tensor, k: int, chunk: int = 256):
    """Exact ``lax.top_k(skey, k)`` of an int32 key vector — the same values
    and the same lowest-index-first ties — as ``(values int32, indices
    int64)``, pruned by contiguous chunk maxima: one max over the chunks, a
    top-k of the ``n/chunk`` maxima, then a top-k of the ``k·chunk``
    candidates, all on :func:`lex_key` keys.

    Exact: a kept chunk's largest key is above every key of a chunk that is
    not kept, so each element outside the kept chunks has ``k`` keys above
    it. Tail padding takes :data:`INT32_MIN` at indices ≥ n, which loses
    every tie to a real row by the index order."""
    n = skey.shape[0]
    idx = torch.arange(n, device=skey.device)
    if n < chunk * k:          # pruning cannot win (or fewer chunks than k)
        return _unkey(torch.topk(lex_key(skey, idx), k).values)
    c = -(-n // chunk)
    keys = lex_key(skey, idx)
    if c * chunk != n:
        tail = torch.arange(n, c * chunk, device=skey.device)
        keys = torch.cat([keys, lex_key(torch.full_like(tail, INT32_MIN),
                                        tail)])
    tiles = keys.reshape(c, chunk)
    cidx = torch.topk(tiles.max(dim=1).values, k).indices
    return _unkey(torch.topk(tiles[cidx].reshape(-1), k).values)


def merge_topk(vals: torch.Tensor, gids: torch.Tensor, k: int
               ) -> torch.Tensor:
    """The first ``k`` user ids of the candidates under (score descending,
    id ascending) — a total order, so the result never depends on how a
    sort breaks ties. ``vals`` are :func:`sortable_f32` keys."""
    return _unkey(torch.topk(lex_key(vals, gids), k).values)[1]


def pack_selected(sel: torch.Tensor, buffer: int, offset: int = 0):
    """Poisson packing of one population slice: the first ``buffer``
    selected rows in index order as user ids (``offset`` + row), vacant
    slots holding :data:`INT32_MAX` (after every real id in
    :func:`merge_poisson`). Returns ``(ids (buffer,) int64, count ())``;
    nothing is read back to the host."""
    n = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int64), 0)
    took = sel & (pos <= buffer)
    # selected rows land at slot pos - 1, the rest in a spare last slot
    slot = torch.where(took, pos - 1, buffer)
    ids = torch.full((buffer + 1,), INT32_MAX, dtype=torch.int64,
                     device=sel.device)
    ids.scatter_(0, slot, torch.arange(n, device=sel.device) + offset)
    return ids[:buffer], torch.clamp(sel.sum(), max=buffer)


def merge_poisson(gids_all: torch.Tensor, counts_all: torch.Tensor,
                  buffer: int):
    """Merge packed Poisson candidate lists: an ascending sort puts real ids
    in index order (sentinels last), and the first ``buffer`` are the first
    ``buffer`` selected users. Only equal sentinels tie, so the sorted
    values do not depend on the sort's handling of ties. Returns ``(ids
    (buffer,), slot_mask (buffer,))``, vacant slots id 0 as in
    `engine.poisson_select`."""
    merged = torch.sort(gids_all).values[:buffer]
    n_took = torch.clamp(counts_all.sum(), max=buffer)
    slot_mask = torch.arange(buffer, device=gids_all.device) < n_took
    return torch.where(slot_mask, merged, 0), slot_mask


def scatter_max(vec: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                value: int, offset: int = 0) -> torch.Tensor:
    """O(cohort) masked scatter-max of ``value`` into the rows ``ids -
    offset`` of ``vec``: masked or out-of-range slots contribute
    :data:`INT32_MIN`, a no-op under max, so duplicate padded ids are
    safe."""
    n = vec.shape[0]
    lid = ids - offset
    ok = mask & (lid >= 0) & (lid < n)
    val = torch.where(ok, int(value), INT32_MIN).to(vec.dtype)
    return vec.scatter_reduce(0, lid.clamp(0, n - 1), val, reduce="amax")


def scatter_add(vec: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                offset: int = 0) -> torch.Tensor:
    """O(cohort) masked scatter-add of 1 into the rows ``ids - offset`` of
    ``vec``: masked or out-of-range slots add exactly 0."""
    n = vec.shape[0]
    lid = ids - offset
    ok = mask & (lid >= 0) & (lid < n)
    return vec.index_add(0, lid.clamp(0, n - 1), ok.to(vec.dtype))
