"""The port's Secret Sharer and canary devices against the JAX package's at
small widths: the canary grid of ``make_canaries`` (drawn from a
``torch.Generator``, so it is checked on its own terms); canary injection
and ``to_device_arrays`` byte for byte for the reference's canaries;
``score_canaries`` / ``log_perplexity``, Random-Sampling ranks on one
numpy-drawn pool of continuations, and the beam-search top-5, each against
the JAX function on the same parameters (carried across by
``from_jax_params``).

Tolerances: scores are sums of three float32 log-probabilities computed by
two frameworks in different orders (log_softmax against logsumexp and a
gather): rtol 1e-5, atol 1e-4. A rank may differ only by pool scores that
lie within that tolerance of the canary's own score (near ties), which are
counted; beams likewise, where two candidates' scores lie within it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import secret_sharer as jss
from repro.data.corpus import BigramCorpus as JCorpus
from repro.data.federated import FederatedDataset as JDataset
from repro.models import build as jax_build
from repro_torch.configs import get_config
from repro_torch.core import secret_sharer as ss
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params, strip_compute

TOL = dict(rtol=1e-5, atol=1e-4)
SMALL = dict(vocab=300, d_model=32, d_ff=64, compute_dtype="float32",
             cell_path="seq")


def _port(canaries):
    return [ss.Canary(tuple(c.tokens), c.n_u, c.n_e) for c in canaries]


@pytest.fixture(scope="module")
def models():
    """The reference's model and the port's on the same parameters; the
    embedding and the projection scaled up so that the next-word
    distributions are peaked (random initial weights give near-uniform
    ones, all scores alike)."""
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**SMALL))
    pm = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    p0 = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    p0["embed"]["tok"] = p0["embed"]["tok"] * 50.0
    p0["w_proj"] = p0["w_proj"] * 4.0
    pp = strip_compute(from_jax_params(p0, pm.compute_copies, device="cpu",
                                       compute_dtype="float32"))
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    canaries = jss.make_canaries(jax.random.PRNGKey(42), vocab=300)
    return jm, jp, pm, pp, canaries


# ----------------------------------------------------------- canaries


def test_make_canaries_grid_prefixes_and_errors():
    grid = ((1, 1), (4, 14), (16, 200))
    cs = ss.make_canaries(torch.Generator().manual_seed(0), vocab=50,
                          grid=grid, per_config=4)
    assert [(c.n_u, c.n_e) for c in cs] == [g for g in grid for _ in range(4)]
    assert all(len(c.tokens) == ss.CANARY_LEN for c in cs)
    assert all(0 <= t < 50 for c in cs for t in c.tokens)
    assert len({c.prefix for c in cs}) == len(cs)
    assert all(c.prefix + c.continuation == c.tokens for c in cs)
    # the paper's default grid: 9 configurations × 3 = 27 canaries
    assert len(ss.make_canaries(torch.Generator().manual_seed(1), 10)) == 27
    # the same generator seed gives the same canaries
    again = ss.make_canaries(torch.Generator().manual_seed(0), vocab=50,
                             grid=grid, per_config=4)
    assert again == cs
    with pytest.raises(ValueError, match="distinct 2-word prefixes"):
        ss.make_canaries(torch.Generator().manual_seed(0), vocab=2,
                         grid=((1, 1),), per_config=5)


def test_injection_and_device_arrays_are_the_references_bytes():
    jcs = jss.make_canaries(jax.random.PRNGKey(42), vocab=300)
    kw = dict(n_users=30, seq_len=8, sentences_per_user=6)
    jds = JDataset(JCorpus(vocab_size=300, seed=2), **kw)
    pds = FederatedDataset(BigramCorpus(vocab_size=300, seed=2), **kw)
    jsyn = jds.inject_canaries(jcs)
    psyn = pds.inject_canaries(_port(jcs))
    assert len(psyn) == len(jsyn) == sum(c.n_u for c in jcs) == 189
    assert [u.user_id for u in psyn] == [u.user_id for u in jsyn]
    for a, b in zip(pds.users, jds.users):
        assert a.is_synthetic == b.is_synthetic
        assert a.examples.tobytes() == b.examples.tobytes()
        assert (a.canary is None) == (b.canary is None)
        if a.canary is not None:
            assert a.canary.tokens == b.canary.tokens
    assert [c.tokens for c in pds.canaries()] == [c.tokens for c in jcs]
    want, got = jds.to_device_arrays(), pds.to_device_arrays()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    cap = pds.to_device_arrays(max_examples=5)
    assert cap["examples"].tobytes() == \
        jds.to_device_arrays(max_examples=5)["examples"].tobytes()
    with pytest.raises(ValueError, match="prefix"):
        pds.inject_canaries(_port(jcs[:2]) * 2)


# ----------------------------------------------------------- scoring


def test_score_canaries_and_log_perplexity_match_jax(models):
    jm, jp, pm, pp, canaries = models
    toks = jss.canary_matrix(canaries)
    want = np.asarray(jss.score_canaries(jm, jp, toks))
    got = ss.score_canaries(pm, pp, ss.canary_matrix(_port(canaries)))
    assert got.dtype == torch.float32 and got.shape == (27,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.ptp(want) > 1.0      # the scores differ: the test can tell
    # the eval hook scores the same thing
    hook = ss.canary_eval_fn(pm, _port(canaries))(pp, 0)
    np.testing.assert_array_equal(hook["canary_logppl"].numpy(), got.numpy())
    # log_perplexity over chunks of another size, and a prefix of 3
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 300, (70, 5)).astype(np.int32)
    np.testing.assert_allclose(
        ss.log_perplexity(pm, pp, seqs, batch_size=32),
        jss.log_perplexity(jm, jp, seqs, batch_size=32), **TOL)
    np.testing.assert_allclose(
        ss.log_perplexity(pm, pp, seqs, prefix_len=3, batch_size=64),
        jss.log_perplexity(jm, jp, seqs, prefix_len=3, batch_size=64), **TOL)


def test_random_sampling_ranks_on_a_shared_pool_match_jax(models):
    jm, jp, pm, pp, canaries = models
    K, n = len(canaries), 600
    pool = np.random.default_rng(7).integers(0, 300, (n, 3)).astype(np.int32)
    toks = jss.canary_matrix(canaries)
    # the JAX scorer on the same pool, every canary's prefix in front
    seqs = np.concatenate([np.repeat(toks[:, None, :2], n, axis=1),
                           np.broadcast_to(pool[None], (K, n, 3))], axis=-1)
    pool_j = np.asarray(jss.score_canaries(
        jm, jp, seqs.reshape(K * n, 5))).reshape(K, n)
    can_j = np.asarray(jss.score_canaries(jm, jp, toks))
    want = (pool_j < can_j[:, None]).sum(axis=1)
    got = ss.random_sampling_ranks(pm, pp, _port(canaries),
                                   continuations=pool, batch_size=128)
    near = (np.abs(pool_j - can_j[:, None])
            <= TOL["atol"] + TOL["rtol"] * np.abs(can_j[:, None])).sum(1)
    assert got.dtype == np.int64 and got.shape == (K,)
    assert np.all(np.abs(got - want) <= near), (got, want, near)
    assert near.sum() <= 2 and len(set(want.tolist())) > 5
    # one canary alone, and a generator-drawn pool of the same size
    assert ss.random_sampling_rank(pm, pp, _port(canaries)[4],
                                   continuations=pool) == got[4]
    g = ss.random_sampling_ranks(pm, pp, _port(canaries)[:3],
                                 torch.Generator().manual_seed(0),
                                 n_samples=300, batch_size=128)
    assert np.all((g >= 0) & (g <= 300))
    with pytest.raises(ValueError, match="generator"):
        ss.random_sampling_ranks(pm, pp, _port(canaries)[:1])


def test_beam_search_top5_matches_jax(models):
    jm, jp, pm, pp, canaries = models
    for c in canaries[:6]:
        want = jss.beam_search(jm, jp, c.prefix, ss.CANARY_LEN)
        got = ss.beam_search(pm, pp, c.prefix, ss.CANARY_LEN)
        assert got == [tuple(t) for t in want]
        assert ss.canary_extracted(pm, pp, _port([c])[0]) == \
            jss.canary_extracted(jm, jp, c)
    # a canary the model was made to predict is extracted by both
    top = tuple(ss.beam_search(pm, pp, canaries[0].prefix, 5)[0])
    made = ss.Canary(top, 1, 1)
    assert ss.canary_extracted(pm, pp, made)
