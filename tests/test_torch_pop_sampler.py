"""The port's block-keyed population sampler primitives
(`repro_torch.fl.pop_sampler`) against the reference's
(`repro.fl.pop_sampler`), exactly: every primitive returns the same integers
and the same order, under heavy ties and tails that do not align with the
pruning chunks. The block draws are held within the port: a block's draws
depend on (seed, round, stream, block) alone, and they leave the engine's
training generator where it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import pop_sampler as jps
from repro_torch.fl import pop_sampler as ps
from repro_torch.fl.engine import EngineDraws

HOSTILE = np.array([-np.inf, -3e38, -1.0, -np.nextafter(np.float32(0), 1),
                    -0.0, 0.0, np.nextafter(np.float32(0), 1),
                    np.float32(1e-40), np.float32(-1e-40), 0.25,
                    np.nextafter(np.float32(0.25), 1), 1.0, 3e38, np.inf],
                   np.float32)


def _np(t):
    return np.asarray(t)


def test_sortable_f32_equals_the_reference_and_keeps_order():
    rng = np.random.default_rng(0)
    bits = rng.integers(-(2 ** 31), 2 ** 31, 4096, dtype=np.int64)
    rand = bits.astype(np.int32).view(np.float32)
    rand = rand[~np.isnan(rand)]
    for xs in (HOSTILE, rand):
        got = ps.sortable_f32(torch.from_numpy(xs)).numpy()
        np.testing.assert_array_equal(got, _np(jps.sortable_f32(
            jnp.asarray(xs))))
    order = np.argsort(HOSTILE, kind="stable")
    keys = ps.sortable_f32(torch.from_numpy(HOSTILE[order])).numpy()
    assert np.all(np.diff(keys.astype(np.int64)) >= 0)
    assert keys[np.nonzero(HOSTILE[order] == -np.inf)[0][0]] > ps.INT32_MIN


@pytest.mark.parametrize("n,k,seed", [(80, 12, 0), (80, 12, 1),
                                      (4096, 200, 0), (51200, 200, 1),
                                      (60_000, 200, 0), (262_145, 16, 1)])
def test_blocked_topk_is_torch_topk_and_lax_top_k(seed, n, k):
    """Values and lowest-index-first ties, on both sides of the pruning
    threshold (n < 256·k takes the direct top-k), under a value set of
    eight keys and lengths that leave a ragged last chunk."""
    rng = np.random.default_rng(seed)
    base = np.array([-(2 ** 31), -7, 0, 3, 3, 3, 9, 2 ** 31 - 1], np.int64)
    skey = rng.choice(base, n).astype(np.int32)
    vals, idx = ps.blocked_topk(torch.from_numpy(skey), k)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(skey), k)
    np.testing.assert_array_equal(vals.numpy(), _np(ref_vals))
    np.testing.assert_array_equal(idx.numpy(), _np(ref_idx))
    keys = ps.lex_key(torch.from_numpy(skey), torch.arange(n))
    top = torch.topk(keys, k).values
    np.testing.assert_array_equal(vals.numpy(), (top >> 32).numpy())
    np.testing.assert_array_equal(idx.numpy(),
                                  (ps.INT32_MAX - (top & 0xFFFFFFFF)).numpy())
    jv, ji = jps.blocked_topk(jnp.asarray(skey), k)
    np.testing.assert_array_equal(vals.numpy(), _np(jv))
    np.testing.assert_array_equal(idx.numpy(), _np(ji))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("groups", [1, 2, 4, 8])
def test_merge_of_group_topk_is_the_flat_topk(seed, groups):
    """Per-group top-k merged by `merge_topk` equals the flat top-k of the
    (score, id) order and the reference's merge of the same candidates,
    under scores drawn from a set of signed zeros, ulp neighbours and
    infinities, so the id tie-break decides."""
    rng = np.random.default_rng(seed)
    per, k = 32, 12
    n = groups * per
    score = rng.choice(HOSTILE, n).astype(np.float32)
    skey = ps.sortable_f32(torch.from_numpy(score))
    vals, gids = [], []
    for g in range(groups):
        v, li = ps.blocked_topk(skey[g * per:(g + 1) * per], k)
        vals.append(v)
        gids.append(g * per + li)
    merged = ps.merge_topk(torch.cat(vals), torch.cat(gids), k)
    flat = np.lexsort((np.arange(n), -skey.numpy().astype(np.int64)))[:k]
    np.testing.assert_array_equal(merged.numpy(), flat)
    ref = jps.merge_topk(jnp.asarray(torch.cat(vals).numpy()),
                         jnp.asarray(torch.cat(gids).numpy(), jnp.int32), k)
    np.testing.assert_array_equal(merged.numpy(), _np(ref))


@pytest.mark.parametrize("seed", range(3))
def test_pack_selected_and_merge_poisson_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    groups, per, buffer = 4, 40, 16
    sel = rng.random(groups * per) < 0.2
    out, ref = [], []
    for g in range(groups):
        part = sel[g * per:(g + 1) * per]
        gid, cnt = ps.pack_selected(torch.from_numpy(part), buffer, g * per)
        rgid, rcnt = jps.pack_selected(jnp.asarray(part), buffer, g * per)
        np.testing.assert_array_equal(gid.numpy(), _np(rgid))
        assert int(cnt) == int(rcnt)
        out.append((gid, cnt[None]))
        ref.append((rgid, rcnt[None]))
    ids, mask = ps.merge_poisson(torch.cat([g for g, _ in out]),
                                 torch.cat([c for _, c in out]), buffer)
    rids, rmask = jps.merge_poisson(jnp.concatenate([g for g, _ in ref]),
                                    jnp.concatenate([c for _, c in ref]),
                                    buffer)
    np.testing.assert_array_equal(ids.numpy(), _np(rids))
    np.testing.assert_array_equal(mask.numpy(), _np(rmask))
    flat = np.nonzero(sel)[0][:buffer]
    assert ids[:flat.shape[0]].tolist() == flat.tolist()
    assert int(mask.sum()) == flat.shape[0]


@pytest.mark.parametrize("offset", [0, 20])
def test_scatters_equal_the_reference(offset):
    rng = np.random.default_rng(offset)
    n, c = 40, 24
    vec = rng.integers(-5, 5, n).astype(np.int32)
    ids = rng.integers(0, 80, c).astype(np.int32)
    ids[:4] = ids[4]                      # duplicates, as padded slots are
    mask = rng.random(c) < 0.7
    tv, ti, tm = (torch.from_numpy(a) for a in (vec, ids, mask))
    got = ps.scatter_max(tv, ti.long(), tm, 7, offset)
    want = jps.scatter_max(jnp.asarray(vec), jnp.asarray(ids),
                           jnp.asarray(mask), jnp.int32(7), offset)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    got = ps.scatter_add(tv, ti.long(), tm, offset)
    want = jps.scatter_add(jnp.asarray(vec), jnp.asarray(ids),
                           jnp.asarray(mask), offset)
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_population_padding_is_the_references():
    for n in (7, 60, 80, 10 ** 6 + 3):
        assert ps.pop_pad(n) == jps.pop_pad(n)
    assert ps.n_pop_blocks() == jps.n_pop_blocks()


def test_block_draws_are_keyed_by_block_and_spare_the_main_generator():
    g = torch.Generator().manual_seed(5)
    d = EngineDraws(g)
    before = g.get_state()
    all8 = d.block_uniforms("available", 3, range(8), 100)
    assert torch.equal(g.get_state(), before)
    # any grouping of blocks draws the same numbers
    for b in (0, 5, 7):
        assert torch.equal(d.block_uniforms("available", 3, [b], 100)[0],
                           all8[b])
    assert torch.equal(d.block_uniforms("available", 3, [6, 2], 100),
                       all8[[6, 2]])
    # another round, stream or seed draws other numbers
    assert not torch.equal(d.block_uniforms("available", 4, range(8), 100),
                           all8)
    assert not torch.equal(d.block_uniforms("sample", 3, range(8), 100),
                           all8)
    other = EngineDraws(torch.Generator().manual_seed(6))
    assert not torch.equal(other.block_uniforms("available", 3, range(8),
                                                100), all8)
    # the Gumbels are the sample stream's uniforms, −log(−log u)
    u = d.block_uniforms("sample", 3, range(8), 100)
    gum = d.block_gumbels(3, range(8), 100)
    assert torch.equal(gum, -torch.log(-torch.log(u)))
    big = d.block_uniforms("available", 0, range(8), 20_000).reshape(-1)
    assert float(big.min()) >= 0 and float(big.max()) < 1
    assert abs(float(big.mean()) - 0.5) < 0.005
    assert abs(float(d.block_gumbels(0, range(8), 20_000).mean())
               - 0.5772) < 0.02
