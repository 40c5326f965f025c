"""The port's clip-and-sum path against the JAX package's: the dp_clip
wrappers (`repro_torch.kernels.dp_clip`) against the Pallas kernels run by
their interpreter, `core.clipping`, the canonical reduction
(`fl.reduction`), and the streaming round body `fl.client.round_compute`
against the reference's on the same stacked batches. Also the port's own
invariants: a masked slot adds exactly ±0 even over 1e30 garbage, and the
round sum is bitwise the same for every ``cohort_chunk`` dividing the block
size.

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
from repro_torch.kernels.dp_clip import (LAUNCHES, clip_accumulate,
                                         clip_accumulate_leaf, fused_sumsq,
                                         sumsq)
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
