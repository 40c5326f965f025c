"""The port's streamed population backend and block-keyed sampler
(`repro_torch.fl.engine.SimEngine(population_backend="streamed",
sampler="sharded")`, `FederatedTrainer(population_store=...)`, the training
CLI's ``--population-store`` / ``--population-backend`` / ``--sampler``).

Against the reference: the port's engine with ``sampler="sharded"``, handed
the reference's draws (`test_torch_engine.RefDraws`) and its ``fold_in``
block draws (:class:`RefBlockDraws`), against `repro.fl.engine.SimEngine(
sampler="sharded").run_python`, fixed and Poisson, σ 0 and 0.3: every
round's cohort, slot count, ``participation`` and ``last_round`` exactly;
params, losses and norms within the tolerance of `test_torch_engine.py`
(float32 params atol 1e-5 / rtol 1e-4; the frameworks order float32 sums
differently). At fixed rounds and σ = 0 both sides take the streamed
backend: the reference's streamed path is not bit-exact with σ > 0 or
Poisson rounds under this tree's jax (ROADMAP.md C2), so it is no oracle
there.

Within the port, bitwise: streamed against device for both samplers, fixed,
Poisson and faulty rounds, ``cohort_chunk`` 1, 4 and 16, ``run`` and
``run_python``, in-memory and mmap stores; a streamed run crash-resumed
through the trainer; the CLI over a store.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import DPConfig as JDPConfig
from repro.configs import get_config as jax_get_config
from repro.data.corpus import BigramCorpus as JCorpus
from repro.data.federated import FederatedDataset as JDataset
from repro.fl import engine as jeng
from repro.fl import pop_sampler as jps
from repro.models import build as jax_build
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.population_store import (InMemoryPopulationStore,
                                               MmapPopulationStore,
                                               ReplicatedPopulationStore,
                                               write_population_store)
from repro_torch.fl import engine as eng
from repro_torch.fl.faults import FaultConfig
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params
from test_torch_engine import (SMALL, TINY, RefDraws, _bitwise,
                               _close_trees, _hist_equal)
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

KW = dict(n_users=60, seq_len=6, sentences_per_user=8)
FAULTS = dict(seed=3, dropout_prob=0.3, straggler_prob=0.2,
              straggler_mean_delay=2.0, round_deadline=3.0, corrupt_prob=0.2)
TINY_MODEL = build(get_config("gboard-cifg-lstm").with_(**TINY))


class RefBlockDraws(RefDraws):
    """`RefDraws` plus the reference's block-keyed draws: block ``b`` from
    ``fold_in(k_avail or k_sample, b)`` of the round's key split."""

    def block_uniforms(self, stream, round_idx, block_ids, blk):
        key = self.k_avail if stream == "available" else self.k_sample
        return torch.from_numpy(np.array(jps.block_uniforms(
            key, jnp.asarray(list(block_ids)), blk)))

    def block_gumbels(self, round_idx, block_ids, blk):
        return torch.from_numpy(np.array(jps.block_gumbels(
            self.k_sample, jnp.asarray(list(block_ids)), blk)))


def _configs(sampling="fixed", sigma=0.3, cohort=8):
    dpkw = dict(clients_per_round=cohort, noise_multiplier=sigma,
                clip_norm=0.05, server_opt="momentum", server_lr=0.5,
                server_momentum=0.9, sampling=sampling)
    return dpkw, dict(local_epochs=1, batch_size=4, lr=0.3)


# ------------------------------------------------ against the reference


def _reference_pair(sampling, sigma, backend, sampler):
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**SMALL))
    pm = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    jdata = JDataset(JCorpus(vocab_size=300, seed=0), **KW).to_device_arrays()
    pdata = FederatedDataset(BigramCorpus(vocab_size=300, seed=0),
                             **KW).to_device_arrays()
    dpkw, clkw = _configs(sampling, sigma)
    ekw = dict(n_local_batches=2, availability=0.6 if sampling == "fixed"
               else 1.0, rounds_per_call=3, sampler=sampler,
               population_backend=backend)
    je = jeng.SimEngine(jm, jdata, JDPConfig(**dpkw), JClientConfig(**clkw),
                        **ekw)
    pe = eng.SimEngine(pm, pdata, DPConfig(**dpkw), ClientConfig(**clkw),
                       **ekw, device="cpu")
    p0 = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    js = je.init_state(jax.tree_util.tree_map(jnp.asarray, p0), seed=0)
    ps = pe.init_state(from_jax_params(p0, pm.compute_copies, device="cpu"),
                       draws=RefBlockDraws(0, pdata["examples"].shape[1]))
    return je, js, pe, ps


def _run_both(je, js, pe, ps, K=3):
    """K rounds on both sides, one round a call: each round's cohort is the
    set of users whose last_round is that round."""
    jhs, phs = [], []
    for r in range(K):
        js, jh = je.run_python(js, 1)
        ps, ph = pe.run_python(ps, 1)
        jlast, plast = np.asarray(js.last_round), ps.last_round.numpy()
        np.testing.assert_array_equal(np.nonzero(plast == r)[0],
                                      np.nonzero(jlast == r)[0])
        jhs.append(jh)
        phs.append(ph)
    cat = lambda hs, k: np.concatenate([np.asarray(h[k]) for h in hs])  # noqa
    for k in ("n_clients",):
        np.testing.assert_array_equal(cat(phs, k), cat(jhs, k))
    for k in ("loss", "mean_update_norm", "frac_clipped"):
        np.testing.assert_allclose(cat(phs, k), cat(jhs, k), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(ps.participation.numpy(),
                                  np.asarray(js.participation))
    np.testing.assert_array_equal(ps.last_round.numpy(),
                                  np.asarray(js.last_round))
    _close_trees(ps.params, js.params)
    _close_trees(ps.opt_state.momentum, js.opt_state.momentum)
    return cat(phs, "n_clients")


# fixed rounds at σ = 0 take the streamed backend on both sides: the one
# case where the reference's streamed path is an oracle (ROADMAP.md C2)
@pytest.mark.parametrize("sampling,sigma,backend", [
    ("fixed", 0.0, "streamed"), ("fixed", 0.3, "device"),
    ("poisson", 0.0, "device"), ("poisson", 0.3, "device")])
def test_sharded_sampler_matches_jax_with_injected_block_draws(
        sampling, sigma, backend):
    je, js, pe, ps = _reference_pair(sampling, sigma, backend, "sharded")
    assert (pe.n_pad, pe.pop_blocks, pe.padded) == \
        (je.n_pad, je.pop_blocks, je.padded) == (64, 8, pe.padded)
    n_clients = _run_both(je, js, pe, ps)
    if sampling == "poisson":
        assert len(set(n_clients.tolist())) > 1   # rounds of several sizes


# ------------------------------------------------------ within the port


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    ds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), **KW)
    data = ds.to_device_arrays()
    mem = InMemoryPopulationStore.from_arrays(data)
    path = write_population_store(tmp_path_factory.mktemp("pop"), mem,
                                  shard_users=16)
    return ds, data, mem, MmapPopulationStore(path)


def _engine(data, backend="device", sampler="global", sampling="fixed",
            faults=None, cohort=8, sigma=0.3, **kw):
    dpkw, clkw = _configs(sampling, sigma, cohort)
    base = dict(n_local_batches=2, availability=0.6, rounds_per_call=2,
                population_backend=backend, sampler=sampler, device="cpu",
                fault_config=None if faults is None else FaultConfig(**faults))
    base.update(kw)
    return eng.SimEngine(TINY_MODEL, data, DPConfig(**dpkw),
                         ClientConfig(**clkw), **base)


def _p0():
    return TINY_MODEL.init(torch.Generator().manual_seed(1), device="cpu")


def _same_run(a, b):
    (sa, ha), (sb, hb) = a, b
    assert _bitwise(sa.params, sb.params)
    assert _bitwise(sa.opt_state.momentum, sb.opt_state.momentum)
    assert torch.equal(sa.participation, sb.participation)
    assert torch.equal(sa.last_round, sb.last_round)
    assert sa.round_idx == sb.round_idx
    assert torch.equal(sa.draws.generator.get_state(),
                       sb.draws.generator.get_state())
    _hist_equal(ha, hb)


@pytest.mark.parametrize("sampler", ["global", "sharded"])
@pytest.mark.parametrize("case", ["fixed", "poisson", "faults"])
def test_streamed_is_bitwise_the_device_backend(stores, sampler, case):
    _, data, mem, mm = stores
    kw = dict(sampler=sampler, sampling="poisson" if case == "poisson"
              else "fixed", faults=FAULTS if case == "faults" else None)
    if case == "poisson":
        kw["availability"] = 1.0
    dev = _engine(data, **kw)
    want = dev.run(dev.init_state(_p0(), seed=4), 3)
    # each store meets each entry point across the two samplers
    ways = (((mem, "run"), (mm, "run_python")) if sampler == "global"
            else ((mem, "run_python"), (mm, "run")))
    for store, meth in ways:
        e = _engine(store, "streamed", **kw)
        _same_run(getattr(e, meth)(e.init_state(_p0(), seed=4), 3), want)
    n_pad = 64 if sampler == "sharded" else 60
    assert want[0].participation.shape == (n_pad,)
    assert int(want[0].participation[60:].sum()) == 0


def test_streamed_is_bitwise_across_cohort_chunk(stores):
    """Cohort 128 over a 160-user replicated view of the 60 users: the
    canonical block holds 16 slots, so chunks of 1, 4 and 16 divide it."""
    _, _, mem, _ = stores
    fleet = ReplicatedPopulationStore(mem, 160)
    want = None
    for backend, chunk in (("device", 16), ("streamed", 16),
                           ("streamed", 4), ("streamed", 1)):
        e = _engine(fleet, backend, "sharded", cohort=128, availability=1.0,
                    cohort_chunk=chunk, n_local_batches=1)
        out = e.run(e.init_state(_p0(), seed=2), 1)
        if want is None:
            want = out
            assert e.padded == 128 and int(out[1]["n_clients"][0]) == 128
        else:
            _same_run(out, want)


def test_staged_bytes_do_not_grow_with_the_population(stores):
    _, _, mem, _ = stores
    out = []
    for n in (60, 6000):
        e = _engine(ReplicatedPopulationStore(mem, n), "streamed", "sharded")
        assert e.corpus_device_bytes == 0
        e.run(e.init_state(_p0(), seed=1), 1)
        out.append(e.corpus_device_bytes)
    assert out[0] == out[1] == 2 * e.padded * mem.emax * mem.row_len * 4
    d = _engine(mem.device_arrays())
    assert d.corpus_device_bytes == 60 * mem.emax * mem.row_len * 4


@pytest.mark.parametrize("backend,sampler", [("device", "global"),
                                             ("streamed", "sharded")])
def test_run_sampler_leaves_the_state_of_full_rounds(stores, backend,
                                                     sampler):
    _, data, mem, _ = stores
    e = _engine(data if backend == "device" else mem, backend, sampler)
    full, _ = e.run(e.init_state(_p0(), seed=5), 3)
    s = e.run_sampler(e.init_state(_p0(), seed=5), 3)
    assert torch.equal(s.participation, full.participation)
    assert torch.equal(s.last_round, full.last_round)
    assert s.round_idx == 3
    assert torch.equal(s.draws.generator.get_state(),
                       full.draws.generator.get_state())


def _trainer(store, ds=None, backend="engine", **kw):
    dpkw, clkw = _configs("fixed", 0.3)
    n = store.n_users if store is not None else len(ds.users) if ds else 60
    return FederatedTrainer(
        TINY_MODEL, ds, DPConfig(**dpkw), ClientConfig(**clkw),
        pop=PopulationSim(n, availability=1.0), seed=0, n_local_batches=2,
        backend=backend, rounds_per_call=2, device="cpu",
        population_store=store, **kw)


def test_trainer_over_a_store_resumes_bitwise(stores, tmp_path):
    ds, _, _, mm = stores
    kw = dict(population_backend="streamed", sampler="sharded",
              fault_config=FaultConfig(**FAULTS))
    full = _trainer(mm, **kw)
    full.train(4)
    part = _trainer(mm, **kw)
    part.train(2)
    part.save_run_state(tmp_path / "state.msgpack")
    resumed = _trainer(mm, **kw)
    assert resumed.restore_run_state(tmp_path / "state.msgpack") == 2
    resumed.train(2)
    assert _bitwise(resumed.state.params, full.state.params)
    assert _bitwise(resumed.state.opt_state.momentum,
                    full.state.opt_state.momentum)
    assert resumed.state.history == full.state.history
    assert resumed.accountant.rounds == full.accountant.rounds
    np.testing.assert_array_equal(resumed.participation, full.participation)
    assert full.participation.shape == (60,)
    # the dataset and its store give the device backend the same run
    a = _trainer(None, ds, sampler="sharded")
    b = _trainer(mm, ds, sampler="sharded")
    a.train(2)
    b.train(2)
    assert _bitwise(a.state.params, b.state.params)


def test_trainer_refuses_what_the_reference_refuses(stores):
    ds, _, mem, _ = stores
    with pytest.raises(ValueError, match="engine-backend"):
        _trainer(mem, ds, backend="host")
    with pytest.raises(ValueError, match="engine-backend"):
        _trainer(None, ds, backend="host", sampler="sharded")
    with pytest.raises(ValueError, match="population_store, or both"):
        _trainer(None, None)
    with pytest.raises(ValueError, match="matching"):
        _trainer(ReplicatedPopulationStore(mem, 61), ds)
    # cohort sharding is ported: one process is not two ranks
    with pytest.raises(ValueError, match="--nproc-per-node 2"):
        _trainer(mem, num_shards=2)


def _cli(*args):
    from repro_torch.launch import train
    return train.main(["--device", "cpu", "--vocab", "300",
                       "--clients-per-round", "8", "--availability", "1.0",
                       *args])


def test_cli_over_a_store(tmp_path, capsys):
    """The CLI over a store built by the port's builder (its crash-resume
    over a store is held in-process above and through the CLI on the card
    by chip_smoke.py phase 10)."""
    from repro_torch.launch import build_corpus
    from repro_torch.train import checkpoint
    store = build_corpus.main(["--out", str(tmp_path / "pop"), "--n-users",
                               "40", "--vocab", "300"])
    flags = ["--population-store", str(store), "--sampler", "sharded"]
    ck = _cli(*flags, "--rounds", "2", "--out", str(tmp_path / "run"))
    out = capsys.readouterr().out
    assert "population store:" in out and "(40 users, E_max=30" in out
    assert "round    2" in out and f"checkpoint: {ck}" in out
    assert checkpoint.load(ck)[1]["rounds"] == "2"
    for bad in (["--inject-canaries", *flags],
                ["--backend", "host", "--sampler", "sharded"],
                ["--backend", "host", "--population-backend", "streamed"]):
        with pytest.raises(SystemExit):
            _cli(*bad, "--out", str(tmp_path / "x"))
