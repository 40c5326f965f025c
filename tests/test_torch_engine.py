"""The port's simulation engine (`repro_torch.fl.engine.SimEngine`) against
the JAX package's `SimEngine.run_python` at small widths, and on its own.

Against the reference, the port is handed the reference's draws: a draws
object rebuilds the reference's key chain (``jax.random.split(key, 5)`` per
round) and calls the reference's own ``sample_cohort``, ``poisson_select``,
``gather_client_batches`` and ``tree_noise`` on those keys. Both engines
then take the same cohorts, example rows and noise from the same starting
parameters for K = 4 rounds, fixed and Poisson, z = 0 and z > 0, with and
without the canary eval hook. Tolerances: float32 params atol 1e-5 / rtol
1e-4, losses and norms rtol 1e-4 (the frameworks order float32 sums
differently); cohorts, participation and round sizes exactly.

Within the port, ``run`` against ``run_python``, the round sum across
``cohort_chunk``, and the trajectory with and without the eval hook are
held bitwise. The port's own generator gets distribution tests: Pace
Steering, the Poisson round size, the example indices, σ = zS/qN within
2%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import DPConfig as JDPConfig
from repro.configs import get_config as jax_get_config
from repro.core import secret_sharer as jss
from repro.data.corpus import BigramCorpus as JCorpus
from repro.data.federated import FederatedDataset as JDataset
from repro.fl import engine as jeng
from repro.models import build as jax_build
from repro.utils.pytree import tree_noise as jax_tree_noise
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.core import secret_sharer as ss
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import engine as eng
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params
from repro_torch.utils.pytree import tree_leaves, tree_map

SMALL = dict(vocab=300, d_model=32, d_ff=64, compute_dtype="float32",
             cell_path="seq")
TINY = dict(vocab=300, d_model=8, d_ff=16, compute_dtype="float32",
            cell_path="seq")
KW = dict(n_users=40, seq_len=6, sentences_per_user=8)
GRID = [(1, 4), (2, 6)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread for a file's tests, restored after: under
    the suite's parallel workers the default thread pools oversubscribe the
    cores and a CLI run of a second takes minutes. Both sides of every
    bitwise comparison in a file run under the same setting. It is autouse
    in this module; `test_torch_faults.py`, `test_torch_streamed.py` and
    `test_torch_train.py` activate it by importing it, so that import must
    stay (pytest applies an imported autouse fixture to the importing
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class RefDraws:
    """The reference engine's draws, behind `EngineDraws`' methods."""

    def __init__(self, seed: int, emax: int):
        self.key = jax.random.PRNGKey(seed)
        self.emax = emax

    def begin_round(self, round_idx):
        (self.key, self.k_avail, self.k_sample, self.k_idx,
         self.k_noise) = jax.random.split(self.key, 5)

    def available(self, n):
        return torch.from_numpy(np.array(
            jax.random.uniform(self.k_avail, (n,))))

    def cohort(self, weights, available, cohort):
        ids = jeng.sample_cohort(self.k_sample, jnp.asarray(weights.numpy()),
                                 jnp.asarray(available.numpy()), cohort)
        return torch.from_numpy(np.array(ids)).long()

    def poisson(self, q, available, buffer):
        out = jeng.poisson_select(self.k_sample, q,
                                  jnp.asarray(available.numpy()), buffer)
        ids, mask, took = (torch.from_numpy(np.array(a)) for a in out)
        return ids.long(), mask, took

    def example_indices(self, counts, need):
        # the reference's gather over a probe corpus whose row e holds e,
        # slot c standing for user c: the tokens it gathers are the indices
        C = counts.shape[0]
        probe = np.broadcast_to(
            np.arange(self.emax, dtype=np.int32)[None, :, None],
            (C, self.emax, 2))
        batch = jeng.gather_client_batches(
            jnp.asarray(probe), jnp.asarray(counts.numpy()), jnp.arange(C),
            jax.random.split(self.k_idx, C), need, 1)
        return torch.from_numpy(
            np.array(batch["tokens"]).reshape(C, need)).long()

    def noise(self, like, std):
        shapes = tree_map(lambda l: np.zeros(l.shape, np.float32), like)
        return tree_map(lambda l: torch.from_numpy(np.array(l)),
                        jax_tree_noise(self.k_noise, shapes, std))


def _configs(sampling, sigma, cohort=8):
    dpkw = dict(clients_per_round=cohort, noise_multiplier=sigma,
                clip_norm=0.05, server_opt="momentum", server_lr=0.5,
                server_momentum=0.9, sampling=sampling)
    clkw = dict(local_epochs=1, batch_size=4, lr=0.3)
    return dpkw, clkw


def _datasets(canaries):
    jds = JDataset(JCorpus(vocab_size=300, seed=0), **KW)
    pds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), **KW)
    jds.inject_canaries(canaries)
    pds.inject_canaries([ss.Canary(tuple(c.tokens), c.n_u, c.n_e)
                         for c in canaries])
    return jds, pds


def _close_trees(a, b):
    for x, y in zip(tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-4)


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _hist_equal(ha, hb):
    assert set(ha) == set(hb)
    for k in ha:
        if isinstance(ha[k], dict):
            _hist_equal(ha[k], hb[k])
        else:
            np.testing.assert_array_equal(ha[k], hb[k], err_msg=k)


# ------------------------------------------------ against the reference


@pytest.mark.parametrize("sampling,sigma,hook", [
    ("fixed", 0.0, False), ("fixed", 0.3, True),
    ("poisson", 0.0, True), ("poisson", 0.3, False)])
def test_engine_matches_jax_run_python_with_injected_draws(sampling, sigma,
                                                           hook):
    K = 4
    cfg = dict(SMALL)
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**cfg))
    pm = build(get_config("gboard-cifg-lstm").with_(**cfg))
    jcan = jss.make_canaries(jax.random.PRNGKey(5), vocab=300, grid=GRID,
                             per_config=1)
    jds, pds = _datasets(jcan)
    dpkw, clkw = _configs(sampling, sigma)
    ekw = dict(n_local_batches=2, availability=0.6 if sampling == "fixed"
               else 1.0, rounds_per_call=3)
    jeval = dict(eval_fn=jss.canary_eval_fn(jm, jcan), eval_every=2) \
        if hook else {}
    je = jeng.SimEngine(jm, jds.to_device_arrays(), JDPConfig(**dpkw),
                        JClientConfig(**clkw), **ekw, **jeval)
    p0 = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    js, jh = je.run_python(je.init_state(jax.tree_util.tree_map(
        jnp.asarray, p0), seed=0), K)

    data = pds.to_device_arrays()
    emax = data["examples"].shape[1]
    pcan = pds.canaries()

    def port(run, with_hook=hook):
        peval = dict(eval_fn=ss.canary_eval_fn(pm, pcan), eval_every=2) \
            if with_hook else {}
        pe = eng.SimEngine(pm, data, DPConfig(**dpkw), ClientConfig(**clkw),
                           **ekw, **peval, device="cpu")
        state = pe.init_state(from_jax_params(p0, pm.compute_copies,
                                              device="cpu"),
                              draws=RefDraws(0, emax))
        return getattr(pe, run)(state, K)

    ps, ph = port("run_python")
    assert np.all(ph["n_clients"] <= je.buffer)
    np.testing.assert_array_equal(ph["n_clients"], jh["n_clients"])
    np.testing.assert_array_equal(ps.participation.numpy(),
                                  np.asarray(js.participation))
    np.testing.assert_array_equal(ps.last_round.numpy(),
                                  np.asarray(js.last_round))
    for k in ("loss", "mean_update_norm", "frac_clipped"):
        np.testing.assert_allclose(ph[k], jh[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(ph["noise_std"], jh["noise_std"], rtol=1e-6)
    _close_trees(ps.params, js.params)
    _close_trees(ps.opt_state.momentum, js.opt_state.momentum)
    if hook:
        np.testing.assert_array_equal(ph["eval_mask"], jh["eval_mask"])
        np.testing.assert_allclose(ph["eval"]["canary_logppl"],
                                   jh["eval"]["canary_logppl"], rtol=1e-5,
                                   atol=1e-4)
    # run (rounds_per_call 3: a call of 3 and a call of 1) is bitwise
    # run_python; with or without the eval hook the trajectory is the same
    rs, rh = port("run")
    assert _bitwise(rs.params, ps.params)
    assert _bitwise(rs.opt_state.momentum, ps.opt_state.momentum)
    _hist_equal(rh, ph)
    ns, nh = port("run", with_hook=not hook)
    assert _bitwise(ns.params, ps.params)
    for k in ("loss", "mean_update_norm", "n_clients"):
        np.testing.assert_array_equal(nh[k], ph[k])


# ------------------------------------------------------ within the port


TINY_MODEL = build(get_config("gboard-cifg-lstm").with_(**TINY))


def _tiny_engine(ds, sampling="fixed", cohort=8, sigma=0.3, **kw):
    dpkw, clkw = _configs(sampling, sigma, cohort)
    model = TINY_MODEL
    base = dict(n_local_batches=2, availability=0.6, rounds_per_call=3,
                device="cpu")
    base.update(kw)
    e = eng.SimEngine(model, ds.to_device_arrays(), DPConfig(**dpkw),
                      ClientConfig(**clkw), **base)
    return e, model


@pytest.fixture(scope="module")
def tiny_ds():
    jcan = jss.make_canaries(jax.random.PRNGKey(5), vocab=300, grid=GRID,
                             per_config=1)
    return _datasets(jcan)[1]


def _p0(model, seed=1):
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


@pytest.mark.parametrize("sampling", ["fixed", "poisson"])
def test_run_is_bitwise_run_python_with_the_ports_generator(tiny_ds,
                                                            sampling):
    e, m = _tiny_engine(tiny_ds, sampling, availability=1.0,
                        eval_fn=ss.canary_eval_fn(TINY_MODEL,
                                                  tiny_ds.canaries()),
                        eval_every=2)
    sa, ha = e.run(e.init_state(_p0(m), seed=3), 5)
    sb, hb = e.run_python(e.init_state(_p0(m), seed=3), 5)
    assert _bitwise(sa.params, sb.params)
    assert _bitwise(sa.opt_state.momentum, sb.opt_state.momentum)
    assert torch.equal(sa.participation, sb.participation)
    _hist_equal(ha, hb)
    np.testing.assert_array_equal(ha["eval_mask"],
                                  [False, True, False, True, False])
    assert np.all(ha["eval"]["canary_logppl"][~ha["eval_mask"]] == 0)
    assert np.all(ha["eval"]["canary_logppl"][ha["eval_mask"]] > 0)
    assert int(sa.participation.sum()) == int(ha["n_clients"].sum())
    assert sa.round_idx == 5 and np.all(np.isfinite(ha["loss"]))
    # another seed draws another trajectory
    sc, _ = e.run(e.init_state(_p0(m), seed=4), 5)
    assert not torch.equal(sc.participation, sa.participation)


@pytest.mark.parametrize("sampling,cohort,chunks", [
    ("fixed", 32, (1, 2, 4)), ("poisson", 16, (1, 5))])
def test_round_sum_is_bitwise_across_cohort_chunk(tiny_ds, sampling, cohort,
                                                  chunks):
    out = []
    for c in chunks:
        e, m = _tiny_engine(tiny_ds, sampling, cohort=cohort, sigma=0.0,
                            availability=1.0, cohort_chunk=c)
        out.append(e.run(e.init_state(_p0(m), seed=2), 2))
    for s, h in out[1:]:
        assert _bitwise(s.params, out[0][0].params)
        _hist_equal(h, out[0][1])
    with pytest.raises(ValueError, match="must divide"):
        _tiny_engine(tiny_ds, sampling, cohort=cohort, cohort_chunk=3)


@pytest.mark.parametrize("sampling", ["fixed", "poisson"])
def test_materializing_path_matches_the_streamed_sum(tiny_ds, sampling):
    """``cohort_chunk=0`` stacks every clipped update and reduces once: the
    same draws and the same round, another association of the sum
    (float32, atol 1e-6 / rtol 1e-5)."""
    out = []
    for c in (0, None):
        e, m = _tiny_engine(tiny_ds, sampling, sigma=0.3, availability=1.0,
                            cohort_chunk=c)
        out.append(e.run(e.init_state(_p0(m), seed=6), 2))
    (sa, ha), (sb, hb) = out
    np.testing.assert_array_equal(ha["n_clients"], hb["n_clients"])
    np.testing.assert_allclose(ha["loss"], hb["loss"], rtol=1e-5)
    for a, b in zip(tree_leaves(sa.params), tree_leaves(sb.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_pace_steering_suppresses_repeats_and_exempts_synthetic(tiny_ds):
    e, m = _tiny_engine(tiny_ds, cohort=8, sigma=0.0, availability=1.0,
                        pace_cooldown=10 ** 6, pace_penalty=1e-9)
    s, h = e.run(e.init_state(_p0(m)), 4)
    part = s.participation.numpy()
    synth = tiny_ds.to_device_arrays()["synthetic"]
    assert part[~synth].max() == 1           # no real device repeats
    assert part[synth].max() >= 2            # synthetic devices do
    assert part.sum() == 4 * 8
    lr = s.last_round.numpy()
    assert set(lr[part > 0].tolist()) <= {0, 1, 2, 3}
    assert np.all(lr[part == 0] == -(10 ** 9))
    # a uniform weight hook lets real devices repeat
    e2, _ = _tiny_engine(tiny_ds, cohort=30, sigma=0.0, availability=1.0,
                         pace_cooldown=10 ** 6, pace_penalty=1e-9,
                         weight_fn=lambda last, synth, r:
                         torch.ones(last.shape))
    s2, _ = e2.run(e2.init_state(_p0(m)), 2)
    assert s2.participation.numpy()[~synth].max() == 2


def test_samplers_of_the_ports_generator():
    g = torch.Generator().manual_seed(0)
    n, cohort = 100, 25
    avail = torch.zeros(n, dtype=torch.bool)
    avail[torch.randperm(n, generator=g)[:30]] = True
    w = torch.ones(n)
    for _ in range(200):
        ids = eng.sample_cohort(g, w, avail, cohort)
        assert len(set(ids.tolist())) == cohort
        assert bool(avail[ids].all())    # never an unavailable device
    few = torch.zeros(n, dtype=torch.bool)
    few[:10] = True
    ids = eng.sample_cohort(g, w, few, cohort)   # topped up, fixed size
    assert len(set(ids.tolist())) == cohort and bool(few[ids].sum() == 10)
    # Poisson: mean realized size ≈ q·|available|, packed in id order
    q, everyone = 0.05, torch.ones(1000, dtype=torch.bool)
    sizes = []
    for _ in range(400):
        ids, mask, took = eng.poisson_select(g, q, everyone, 96)
        k = int(mask.sum())
        sizes.append(k)
        assert torch.equal(ids[:k], torch.nonzero(took)[:, 0])
        assert bool((ids[k:] == 0).all()) and int(took.sum()) == k
    assert abs(np.mean(sizes) / 50 - 1) < 0.03
    ids, mask, took = eng.poisson_select(g, 0.5, everyone, 16)
    assert bool(mask.all()) and int(took.sum()) == 16   # overflow truncated
    # example indices: uniform in [0, count), never count itself
    counts = torch.tensor([1, 2, 7, 200])
    idx = eng.example_indices(g, counts, 5000)
    assert bool((idx >= 0).all()) and bool((idx < counts[:, None]).all())
    assert set(idx[2].tolist()) == set(range(7))
    assert abs(idx[3].float().mean().item() / 99.5 - 1) < 0.05


def test_noise_std_is_zS_over_qN(tiny_ds):
    e, m = _tiny_engine(tiny_ds, sigma=0.3)
    state = e.init_state(_p0(m))
    std = 0.3 * 0.05 / 8
    like = tree_map(lambda l: torch.zeros((64,) + tuple(l.shape)),
                    state.params)
    flat = torch.cat([l.reshape(-1) for l in
                      tree_leaves(state.draws.noise(like, std))])
    assert abs(float(flat.std()) / std - 1) < 0.02
    _, h = e.run(state, 1)
    assert h["noise_std"][0] == pytest.approx(std)


def test_unported_options_raise(tiny_ds):
    # cohort sharding is ported (tests/test_torch_engine_sharded.py): in a
    # process that is not one of num_pods x num_shards ranks it raises,
    # naming the launch command
    from repro_torch.configs.base import MeshConfig
    from repro_torch.sharding.specs import sim_mesh_config

    for kw in (dict(num_shards=2), dict(num_pods=2)):
        with pytest.raises(ValueError, match="needs 2 ranks but only 1 are "
                           "running.*--nproc-per-node 2"):
            _tiny_engine(tiny_ds, **kw)
    with pytest.raises(ValueError, match="batch axes only"):
        _tiny_engine(tiny_ds, mesh_config=MeshConfig((1, 2),
                                                     ("data", "model")))
    with pytest.raises(ValueError, match="disagrees with mesh_config"):
        _tiny_engine(tiny_ds, num_shards=4, mesh_config=sim_mesh_config(2))
    e, _ = _tiny_engine(tiny_ds, mesh_config=sim_mesh_config(1))
    assert (e.total_shards, e.mesh, e.rank) == (1, None, 0)
    # the streamed backend and the sharded sampler are ported
    for kw in (dict(population_backend="streamed"), dict(sampler="sharded")):
        e, _ = _tiny_engine(tiny_ds, **kw)
        assert (e.population_backend, e.sampler) == (
            kw.get("population_backend", "device"),
            kw.get("sampler", "global"))
    with pytest.raises(ValueError, match="population_backend"):
        _tiny_engine(tiny_ds, population_backend="nope")
    with pytest.raises(ValueError, match="sampler"):
        _tiny_engine(tiny_ds, sampler="nope")
    with pytest.raises(ValueError, match="clip_path"):
        _tiny_engine(tiny_ds, clip_path="nope")
    with pytest.warns(UserWarning, match="poisson_buffer"):
        _tiny_engine(tiny_ds, "poisson", poisson_buffer=8,
                     availability=1.0)
    with pytest.warns(UserWarning, match="expected check-ins"):
        _tiny_engine(tiny_ds, cohort=40, availability=0.01)


def test_trainer_engine_steps_the_accountant_and_mirrors_participation(
        tiny_ds):
    model = TINY_MODEL
    dpkw, clkw = _configs("fixed", 0.3, cohort=8)
    synth = [u.user_id for u in tiny_ds.users if u.is_synthetic]
    out = {}
    for backend in ("engine", "engine_python"):
        pop = PopulationSim(len(tiny_ds.users), availability=0.6,
                            synthetic_ids=synth)
        tr = FederatedTrainer(model, tiny_ds, DPConfig(**dpkw),
                              ClientConfig(**clkw), pop=pop, seed=0,
                              n_local_batches=2, backend=backend,
                              rounds_per_call=2, device="cpu",
                              eval_fn=ss.canary_eval_fn(
                                  model, tiny_ds.canaries()), eval_every=2)
        tr.train(3)
        tr.run_round()
        assert tr.accountant.rounds == 4 and tr.state.round_idx == 4
        assert tr.participation.sum() == 4 * 8
        np.testing.assert_array_equal(
            tr.participation, tr._estate.participation.numpy())
        np.testing.assert_array_equal(pop._last_round,
                                      tr._estate.last_round.numpy())
        assert tr.eval_history["round"].tolist() == [1, 2, 3, 4]
        assert tr.eval_history["mask"].tolist() == [False, True, False, True]
        assert tr.eval_history["values"]["canary_logppl"].shape == (4, 2)
        out[backend] = tr
    a, b = out["engine"], out["engine_python"]
    assert a.state.history == b.state.history
    assert _bitwise(a.state.params, b.state.params)
    assert tr.accountant.get_epsilon(1e-6) > 0
    with pytest.raises(ValueError, match="eval_fn"):
        FederatedTrainer(model, tiny_ds, DPConfig(**dpkw),
                         ClientConfig(**clkw), eval_fn=lambda p, r: {},
                         device="cpu")
    with pytest.raises(ValueError, match="synthetic"):
        FederatedTrainer(model, tiny_ds, DPConfig(**dpkw),
                         ClientConfig(**clkw), backend="engine",
                         pop=PopulationSim(len(tiny_ds.users)), device="cpu")
    # shards need as many ranks; the host backend refuses them
    with pytest.raises(ValueError, match="--nproc-per-node 2"):
        FederatedTrainer(model, tiny_ds, DPConfig(**dpkw),
                         ClientConfig(**clkw), backend="engine",
                         num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="engine-backend"):
        FederatedTrainer(model, tiny_ds, DPConfig(**dpkw),
                         ClientConfig(**clkw), backend="host",
                         num_shards=2, device="cpu")


def test_training_cli_engine_with_canaries_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    from repro_torch.train import checkpoint

    ck = train.main(["--backend", "engine", "--inject-canaries", "--device",
                     "cpu", "--vocab", "300", "--rounds", "3", "--n-users",
                     "40", "--clients-per-round", "8", "--rounds-per-call",
                     "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "injected 27 canaries (189 synthetic devices)" in out
    assert "round    3" in out and "eps=" in out and f"checkpoint: {ck}" in out
    tree, meta = checkpoint.load(ck)
    assert meta["rounds"] == "3" and tree["w_h"].shape == (256, 768)
    # shards are ported: outside torchrun (one process) they are refused
    # with the launch command
    for flag in (["--num-shards", "2"], ["--num-pods", "2"]):
        with pytest.raises(SystemExit):
            train.main(["--device", "cpu"] + flag)
        assert "--nproc-per-node 2" in capsys.readouterr().err
    # the streamed backend and the sharded sampler are ported: the host
    # backend refuses them, as the reference's CLI does
    for flag in (["--sampler", "sharded"],
                 ["--population-backend", "streamed"]):
        with pytest.raises(SystemExit):
            train.main(["--device", "cpu", "--backend", "host"] + flag)
        assert "engine backend" in capsys.readouterr().err


def test_engine_entry_points_run_on_cuda_unless_asked_for_the_cpu(tiny_ds,
                                                                  tmp_path):
    """``FederatedTrainer(backend="engine" | "engine_python")``,
    ``SimEngine`` and the training CLI default to ``cuda``: without a GPU
    they raise rather than fall back to the CPU."""
    from repro_torch.launch import train

    dpkw, clkw = _configs("fixed", 0.3)
    if torch.cuda.is_available():
        e = eng.SimEngine(TINY_MODEL, tiny_ds.to_device_arrays(),
                          DPConfig(**dpkw), ClientConfig(**clkw))
        assert e.device.type == "cuda"
        return
    for backend in ("engine", "engine_python"):
        with pytest.raises(RuntimeError, match="CUDA"):
            FederatedTrainer(TINY_MODEL, tiny_ds, DPConfig(**dpkw),
                             ClientConfig(**clkw), backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        eng.SimEngine(TINY_MODEL, tiny_ds.to_device_arrays(),
                      DPConfig(**dpkw), ClientConfig(**clkw))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--backend", "engine", "--inject-canaries", "--vocab",
                    "300", "--rounds", "1", "--n-users", "10",
                    "--clients-per-round", "4", "--out", str(tmp_path)])
