"""The port's clip-and-sum path against the JAX package's: the dp_clip
wrappers (`repro_torch.kernels.dp_clip`) against the Pallas kernels run by
their interpreter, `core.clipping`, the canonical reduction
(`fl.reduction`), and the streaming round body `fl.client.round_compute`
against the reference's on the same stacked batches. Also the port's own
invariants: a masked slot adds exactly ±0 even over 1e30 garbage, and the
round sum is bitwise the same for every ``cohort_chunk`` dividing the block
size, and one accumulate over a chunk of clients gives the bits of one per
client and of the reference's ``reduction.slot_fold``.

Tolerances: sums of squares differ only in their order (float32, rtol
1e-5); clipped sums and stats of a round at float32 compute within
atol 1e-6 / rtol 1e-4 (two frameworks, two orders of every float32 sum, two
SGD steps). The CUDA kernels themselves run only on a card
(tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import DPConfig as JDPConfig
from repro.configs import get_config as jax_get_config
from repro.fl import client as jclient
from repro.fl import reduction as jred
from repro.kernels.dp_clip import ops as jclip
from repro.models import build as jax_build
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.core.clipping import (clip_accumulate_tree,
                                       clip_by_global_norm)
from repro_torch.fl import reduction
from repro_torch.fl.client import chunk_accumulate, round_compute
from repro_torch.kernels.dp_clip import (LAUNCHES, MAX_CHUNK,
                                         clip_accumulate,
                                         clip_accumulate_chunk,
                                         clip_accumulate_chunk_leaf,
                                         clip_accumulate_leaf, fused_sumsq,
                                         sumsq, sumsq_chunk)
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params, with_compute_copies
from repro_torch.utils.pytree import tree_leaves, tree_map

SHAPES = {"a": (1,), "b": (127,), "c": {"d": (33, 7), "e": (300, 5)}}
SMALL = dict(vocab=300, d_model=32, d_ff=64, compute_dtype="float32")


def _tree(seed, scale=1.0, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {k: (_tree(seed + i + 1, scale, v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for i, (k, v) in enumerate(sorted(shapes.items()))}


def _t(tree):
    return tree_map(torch.from_numpy, tree)


def _np(tree):
    return [np.asarray(l) for l in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("n", [1, 127, 32769])
def test_sumsq_matches_jax_pallas_interpret(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want = float(jclip.fused_sumsq({"x": x}, interpret=True))
    np.testing.assert_allclose(float(sumsq(torch.from_numpy(x))), want,
                               rtol=1e-5)


def test_fused_sumsq_adds_leaves_in_sorted_key_order():
    tree = _tree(0)
    want = float(jclip.fused_sumsq(tree, interpret=True))
    got = fused_sumsq(_t(tree))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    parts = [sumsq(l) for l in tree_leaves(_t(tree))]
    assert torch.equal(got, sum(parts))   # the order of tree_leaves


@pytest.mark.parametrize("scale", [0.0, 1.0])
@pytest.mark.parametrize("clip_norm", [0.5, 100.0])
def test_clip_accumulate_matches_jax(scale, clip_norm):
    acc, delta = _tree(1), _tree(2, 0.3)
    jacc, jnorm = jclip.clip_accumulate(acc, delta, clip_norm,
                                        jnp.float32(scale), interpret=True)
    pacc, pnorm = clip_accumulate(_t(acc), _t(delta), clip_norm,
                                  torch.tensor(scale))
    np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-5)
    for a, b in zip(tree_leaves(pacc), _np(jacc)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-5)


def test_masked_slot_adds_exactly_zero_over_garbage():
    acc = _t(_tree(3))
    garbage = tree_map(lambda l: torch.full_like(l, 1e30), acc)
    new, norm = clip_accumulate(acc, garbage, 0.8, torch.tensor(0.0))
    assert not torch.isfinite(norm)
    for a, b in zip(tree_leaves(new), tree_leaves(acc)):
        assert torch.equal(a, b)
    # and the reference agrees that nothing moved
    jnew, _ = jclip.clip_accumulate(_tree(3), tree_map(
        lambda l: l.numpy(), garbage), 0.8, jnp.float32(0.0), interpret=True)
    for a, b in zip(_np(jnew), tree_leaves(acc)):
        np.testing.assert_array_equal(a, b.numpy())


def test_leaf_wrappers_on_cpu_are_the_plain_versions():
    before = dict(LAUNCHES)
    x = torch.randn(50)
    acc = torch.randn(50)
    f = torch.tensor(0.25)
    assert torch.equal(sumsq(x), torch.sum(x * x))
    assert torch.equal(clip_accumulate_leaf(acc, x, f), acc + f * x)
    assert LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device"])
def test_leaf_wrappers_reject_what_the_kernels_do_not_take(bad):
    acc, delta, f = torch.zeros(8), torch.ones(8), torch.tensor(1.0)
    if bad == "dtype":
        with pytest.raises(TypeError):
            sumsq(delta.double())
        with pytest.raises(TypeError):
            clip_accumulate_leaf(acc, delta.half(), f)
    elif bad == "shape":
        with pytest.raises(ValueError):
            clip_accumulate_leaf(acc, torch.ones(9), f)
    else:
        with pytest.raises(ValueError):
            clip_accumulate_leaf(acc.to("meta"), delta, f)


def _chunk(C, n, seed):
    """acc, C deltas and C factors from numpy: slot 1 masked (factor 0)
    over 1e30 garbage, the rest clip factors in (0, 1]."""
    rng = np.random.default_rng(seed)
    acc = rng.standard_normal(n).astype(np.float32)
    deltas = [(rng.standard_normal(n) * 0.3).astype(np.float32)
              for _ in range(C)]
    f = rng.uniform(0.05, 1.0, C).astype(np.float32)
    if C > 1:
        deltas[1] = np.where(np.arange(n) % 2, 1e30, -1e30).astype(np.float32)
        f[1] = 0.0
    return acc, deltas, f


@pytest.mark.parametrize("n", [1, 127, 4099])
@pytest.mark.parametrize("C", [1, 2, 7, 16, 32])
def test_chunk_accumulate_leaf_is_one_client_calls_and_slot_fold(C, n):
    """On the CPU the chunk wrapper is its plain version: bitwise C calls of
    the one-client wrapper, and the reference's slot_fold over the same
    products (f·Δ rounded to float32, then summed left to right)."""
    acc, deltas, f = _chunk(C, n, seed=C * 1000 + n)
    before = dict(LAUNCHES)
    got = clip_accumulate_chunk_leaf(
        torch.from_numpy(acc), [torch.from_numpy(d) for d in deltas],
        torch.from_numpy(f))
    assert LAUNCHES == before                     # no kernel on the CPU
    seq = torch.from_numpy(acc)
    for c in range(C):
        seq = clip_accumulate_leaf(seq, torch.from_numpy(deltas[c]),
                                   torch.tensor(f[c]))
    assert torch.equal(got, seq)
    products = np.stack([f[c] * deltas[c] for c in range(C)])
    want = jred.slot_fold({"x": jnp.asarray(acc)},
                          {"x": jnp.asarray(products)})["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).all()         # the garbage added ±0
    out = torch.from_numpy(acc.copy())
    assert clip_accumulate_chunk_leaf(
        out, [torch.from_numpy(d) for d in deltas], torch.from_numpy(f),
        out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("bad", ["empty", "too_many", "shape", "factors",
                                 "dtype", "factor_dtype"])
def test_chunk_accumulate_leaf_rejects_what_the_kernel_does_not_take(bad):
    acc, d, f = torch.zeros(8), torch.ones(8), torch.ones(1)
    args = {"empty": (acc, [], torch.ones(0)),
            "too_many": (acc, [d] * (MAX_CHUNK + 1),
                         torch.ones(MAX_CHUNK + 1)),
            "shape": (acc, [d, torch.ones(9)], torch.ones(2)),
            "factors": (acc, [d, d], torch.ones(3)),
            "dtype": (acc, [d.double()], f),
            "factor_dtype": (acc, [d], f.half())}[bad]
    err = TypeError if "dtype" in bad else ValueError
    with pytest.raises(err):
        clip_accumulate_chunk_leaf(*args)


def _per_slot_chunk_accumulate(acc, deltas, losses, mask, clip_norm,
                               guard_nonfinite):
    """The fold chunk_accumulate replaced: one clip_accumulate_tree (one
    accumulate launch per leaf) per slot, stats added slot by slot."""
    upd, stats = acc
    m = mask.float()
    for i, delta in enumerate(deltas):
        loss, mi = losses[i], m[i]
        if guard_nonfinite:
            ok = torch.stack([torch.isfinite(l).all()
                              for l in tree_leaves(delta)]
                             + [torch.isfinite(loss)]).all().float()
            delta = tree_map(lambda l: torch.where(torch.isfinite(l), l, 0.0),
                             delta)
            loss = torch.where(torch.isfinite(loss), loss, 0.0)
            mi = mi * ok
        upd, norm, flag = clip_accumulate_tree(upd, delta, clip_norm,
                                               scale=mi)
        stats = stats + torch.stack([norm * mi, flag * mi, loss * mi, mi])
    return upd, stats


@pytest.mark.parametrize("guard", [False, True])
@pytest.mark.parametrize("C", [1, 5, 40])
def test_chunk_accumulate_is_bitwise_the_per_slot_loop(C, guard):
    """One accumulate per leaf for the chunk (in runs of at most MAX_CHUNK
    slots) gives the bits of the per-slot loop: masked slots, a slot over
    1e30 garbage under a zero mask and, with the guard, a NaN slot."""
    deltas = [_tree(40 + i, 0.3) for i in range(C)]
    losses = np.linspace(1.0, 2.0, C).astype(np.float32)
    mask = np.ones(C, np.float32)
    if C > 1:
        mask[1] = 0.0
        deltas[1] = tree_map(lambda l: np.full_like(l, 1e30), deltas[1])
    if C > 2:
        deltas[2]["c"]["d"][3, 4] = np.nan if guard else 0.0
        losses[2] = np.nan if guard else losses[2]
    acc = (_t(_tree(7)), torch.tensor([0.5, 1.0, 2.0, 3.0]))
    args = ([_t(d) for d in deltas], torch.from_numpy(losses),
            torch.from_numpy(mask), 0.05)
    got = chunk_accumulate(acc, *args, guard_nonfinite=guard)
    want = _per_slot_chunk_accumulate(acc, *args, guard_nonfinite=guard)
    for a, b in zip(tree_leaves(got[0]), tree_leaves(want[0])):
        assert torch.equal(a, b)
    # bits, not values: the garbage slot's norm is inf, and inf·0 is NaN
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    if guard and C > 2:
        assert float(got[1][3]) == 3.0 + C - 2  # the NaN slot is dropped
    # the tree-level chunk call: the norms of the unmasked deltas
    new, norms = clip_accumulate_chunk(acc[0], args[0][:1], 0.05, [None])
    assert len(norms) == 1 and float(norms[0]) > 0
    assert torch.equal(tree_leaves(new)[0], tree_leaves(
        clip_accumulate(acc[0], args[0][0], 0.05)[0])[0])


@pytest.mark.parametrize("clip_norm", [0.5, 100.0])
def test_clip_by_global_norm_and_tree_path_match_jax(clip_norm):
    from repro.core.clipping import clip_by_global_norm as jclip_norm

    delta = _tree(4, 0.3)
    jc, jn, jf = jclip_norm(delta, clip_norm)
    pc, pn, pf = clip_by_global_norm(_t(delta), clip_norm)
    np.testing.assert_allclose(float(pn), float(jn), rtol=1e-5)
    assert float(pf) == float(jf)
    for a, b in zip(tree_leaves(pc), _np(jc)):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-7, rtol=1e-5)
    acc = _t(_tree(5))
    fused = clip_accumulate_tree(acc, _t(delta), clip_norm, clip_path="fused")
    tree = clip_accumulate_tree(acc, _t(delta), clip_norm, clip_path="tree")
    np.testing.assert_allclose(float(fused[1]), float(tree[1]), rtol=1e-5)
    assert float(fused[2]) == float(tree[2])
    for a, b in zip(tree_leaves(fused[0]), tree_leaves(tree[0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError, match="clip_path"):
        clip_accumulate_tree(acc, _t(delta), clip_norm, clip_path="pallas")


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_fold_blocks_and_grid_helpers_match_jax(n):
    a = np.random.default_rng(n).standard_normal((n, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        reduction.fold_blocks(torch.from_numpy(a)).numpy(),
        np.asarray(jred.fold_blocks(jnp.asarray(a))))
    for shards in (1, 2, 3, 4, 8):
        assert reduction.canon_pad(n * 7, shards) == jred.canon_pad(n * 7,
                                                                    shards)
        assert reduction.n_canon_blocks(shards) == jred.n_canon_blocks(shards)
    for chunk in (None, 0, 1, 3, 64):
        assert reduction.resolve_chunk(chunk, n * 4, strict=False) == \
            jred.resolve_chunk(chunk, n * 4, strict=False)
    assert reduction.auto_chunk(n * 4) == jred.auto_chunk(n * 4)
    b = np.random.default_rng(n).standard_normal((n * 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        reduction.block_sums(torch.from_numpy(b), 4).numpy(),
        np.asarray(jred.block_sums(jnp.asarray(b), 4)), rtol=1e-6, atol=1e-6)


def test_slot_fold_and_resolve_chunk_contract():
    x = torch.randn(6, 3)
    acc = reduction.slot_fold({"x": torch.zeros(3)}, {"x": x})["x"]
    want = torch.zeros(3)
    for i in range(6):
        want = want + x[i]
    assert torch.equal(acc, want)
    with pytest.raises(ValueError, match="divide"):
        reduction.resolve_chunk(3, 8)


def test_chunk_accumulate_guard_matches_jax():
    """A slot with a NaN in its delta is rejected: its values are zeroed
    and its mask dropped, so it adds ±0 and is not counted."""
    deltas = [_tree(10 + i, 0.3) for i in range(3)]
    deltas[1]["b"][5] = np.nan
    losses = np.array([1.0, 2.0, 3.0], np.float32)
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    zero = tree_map(np.zeros_like, deltas[0])
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *deltas)
    jupd, jstats = jclient.chunk_accumulate(
        (zero, jnp.zeros(4)), stacked, losses, mask, 0.5,
        interpret=True, guard_nonfinite=True)
    pupd, pstats = chunk_accumulate(
        (_t(zero), torch.zeros(4)), [_t(d) for d in deltas],
        torch.from_numpy(losses), torch.from_numpy(mask), 0.5,
        guard_nonfinite=True)
    assert float(pstats[3]) == 1.0 == float(jstats[3])
    np.testing.assert_allclose(pstats.numpy(), np.asarray(jstats), rtol=1e-5)
    for a, b in zip(tree_leaves(pupd), _np(jupd)):
        assert np.isfinite(a.numpy()).all()
        np.testing.assert_allclose(a.numpy(), b, atol=1e-7, rtol=1e-5)


# ------------------------------------------------------------ round body


def _round_setup(C, seed=0, nb=2, B=3, S=5):
    jcfg = jax_get_config("gboard-cifg-lstm").with_(cell_path="seq", **SMALL)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = build(get_config("gboard-cifg-lstm").with_(cell_path="seq", **SMALL))
    pp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         pm.compute_copies, device="cpu",
                         compute_dtype="float32")
    rng = np.random.default_rng(seed + 1)
    ex = rng.integers(4, 300, size=(C, nb, B, S + 1)).astype(np.int32)
    ex[:, :, :, -2:] *= rng.random((C, nb, B, 2)) > 0.3   # some PAD labels
    batches = {"tokens": ex[..., :-1], "labels": ex[..., 1:],
               "mask": (ex[..., 1:] != 0).astype(np.float32)}
    return jm, jp, pm, pp, batches


_CLIENT = dict(local_epochs=1, batch_size=3, lr=0.5)


def test_round_compute_matches_jax_with_mask():
    jm, jp, pm, pp, batches = _round_setup(C=10)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1, 1], np.float32)
    jout = jclient.round_compute(
        jm, jp, {k: jnp.asarray(v) for k, v in batches.items()},
        JClientConfig(**_CLIENT), JDPConfig(clip_norm=0.006), jnp.asarray(mask),
        interpret=True)
    pout = round_compute(pm, pp, {k: torch.from_numpy(v)
                                  for k, v in batches.items()},
                         ClientConfig(**_CLIENT), DPConfig(clip_norm=0.006),
                         torch.from_numpy(mask))
    for a, b in zip(tree_leaves(pout[0]), _np(jout[0])):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-6, rtol=1e-4)
    for a, b in zip(pout[1:], jout[1:]):
        np.testing.assert_allclose(float(a), float(b), atol=1e-6, rtol=1e-4)
    assert 0.0 < float(pout[2]) < 1.0   # some updates were clipped


def test_round_sum_is_bitwise_across_chunks_and_close_to_materialized():
    _, _, pm, pp, batches = _round_setup(C=16, seed=3)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    mask = torch.ones(16)
    mask[[4, 5, 9]] = 0.0
    cl, dp = ClientConfig(**_CLIENT), DPConfig(clip_norm=0.006)
    outs = {c: round_compute(pm, pp, tb, cl, dp, mask, cohort_chunk=c)
            for c in (1, 2, 0)}          # block size 2
    for a, b in zip(tree_leaves(outs[1][0]), tree_leaves(outs[2][0])):
        assert torch.equal(a, b)
    for a, b in zip(outs[1][1:], outs[2][1:]):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(outs[0][0]), tree_leaves(outs[2][0])):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)
    for a, b in zip(outs[0][1:], outs[2][1:]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-4)


def test_round_compute_ignores_cached_compute_copies():
    """The round sum keys are the parameters': no "compute" entry reaches
    a delta, a sum of squares or the sum, and stale copies change nothing."""
    _, _, pm, pp, batches = _round_setup(C=4, seed=5)
    tb = {k: torch.from_numpy(v) for k, v in batches.items()}
    cl, dp = ClientConfig(**_CLIENT), DPConfig(clip_norm=0.006)
    clean = {k: v for k, v in pp.items() if k != "compute"}
    stale = with_compute_copies(tree_map(torch.zeros_like, clean), "float32",
                                pm.compute_copies)
    stale = {**clean, "compute": stale["compute"]}
    a = round_compute(pm, stale, tb, cl, dp)
    b = round_compute(pm, clean, tb, cl, dp)
    assert "compute" not in a[0] and set(a[0]) == set(clean)
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)


# ------------------------------------------- sum of squares of a chunk


@pytest.mark.parametrize("C", [1, 3, 16])
def test_sumsq_chunk_matches_jax_fused_sumsq_per_slot(C):
    """Each slot's sum of squares against the reference's fused_sumsq (the
    Pallas kernel in interpret mode); norms and factors against the
    reference's clip factor; float32 sums in another order: rtol 1e-5."""
    from repro.kernels.dp_clip.ref import clip_factor_ref as jfactor

    trees = [_tree(90 + c, 0.3 if c % 2 else 3.0) for c in range(C)]
    ss, norms, factors = sumsq_chunk([_t(t) for t in trees], 0.8)
    assert ss.shape == norms.shape == factors.shape == (C,)
    for c, tree in enumerate(trees):
        want = jclip.fused_sumsq(tree, interpret=True)
        np.testing.assert_allclose(float(ss[c]), float(want), rtol=1e-5)
        np.testing.assert_allclose(float(norms[c]), float(np.sqrt(want)),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(factors[c]),
                                   float(jfactor(want, 0.8)), rtol=1e-5)


def test_sumsq_chunk_is_bitwise_fused_sumsq_and_clip_factor_in_any_chunk():
    """A client's ss, norm and factor are the bits of fused_sumsq +
    clip_factor · mask in every chunk width 1-16 and slot position; a
    masked slot's factor is 0 (also over 1e30 garbage)."""
    from repro_torch.core.clipping import clip_factor

    trees = [_t(_tree(100 + c, 0.3 if c % 3 else 2.0)) for c in range(16)]
    trees[7] = tree_map(lambda l: torch.full_like(l, 1e30), trees[7])
    mask = [torch.tensor(0.0 if c in (5, 7) else 1.0) for c in range(16)]
    ss, norms, factors = sumsq_chunk(trees, 0.8, mask)
    for c, tree in enumerate(trees):
        s1 = fused_sumsq(tree)
        assert torch.equal(ss[c], s1)
        assert torch.equal(norms[c], torch.sqrt(s1))
        assert torch.equal(factors[c],
                           clip_factor(torch.sqrt(s1), 0.8) * mask[c])
    assert float(factors[5]) == 0.0 and float(factors[7]) == 0.0
    for C in range(1, 17):
        for c0 in range(0, 17 - C):
            got = sumsq_chunk(trees[c0:c0 + C], 0.8, mask[c0:c0 + C])
            for a, b in zip(got, (ss, norms, factors)):
                assert torch.equal(a.view(torch.int32),
                                   b[c0:c0 + C].view(torch.int32))


def test_sumsq_chunk_without_scales_and_its_one_leaf_call():
    trees = [_t(_tree(110 + c)) for c in range(3)]
    ss, _, factors = sumsq_chunk(trees, 100.0)
    _, _, masked = sumsq_chunk(trees, 100.0, [None, torch.tensor(1.0), None])
    assert torch.equal(factors, masked) and torch.equal(factors,
                                                        torch.ones(3))
    x = torch.randn(4099)
    assert torch.equal(sumsq_chunk([{"x": x}], 1.0)[0][0], sumsq(x))


@pytest.mark.parametrize("bad", ["empty", "structure", "scales", "dtype"])
def test_sumsq_chunk_rejects_what_the_kernel_does_not_take(bad):
    trees = [{"a": torch.ones(5), "b": torch.ones(3)} for _ in range(2)]
    kw = {}
    if bad == "empty":
        trees = []
    elif bad == "structure":
        trees[1] = {"a": torch.ones(5), "b": torch.ones(4)}
    elif bad == "scales":
        kw = {"scales": [None]}
    else:
        trees[1] = {"a": torch.ones(5), "b": torch.ones(3).double()}
    with pytest.raises((ValueError, TypeError)):
        sumsq_chunk(trees, 1.0, **kw)

