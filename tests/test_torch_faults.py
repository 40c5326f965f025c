"""The port's production fault model and crash-resume
(`repro_torch.fl.faults`, the fault branches of `repro_torch.fl.engine`,
`FederatedTrainer.save_run_state` / `restore_run_state`, the training CLI's
``--fault-*`` / ``--report-goal`` / ``--checkpoint-every`` / ``--resume`` /
``--crash-after``) and the checkpoint reader that needs no ``msgpack``.

Against the reference: `FaultConfig`'s validation and derived quantities
exactly; the engine, handed the reference's draws *and* its fault fates
(`repro.fl.faults.fault_fates`), against `repro.fl.engine.SimEngine.
run_python(fault_config=...)` on the device backend, fixed and Poisson,
``cohort_chunk`` 1 and 2. Round sizes, reported and accepted counts and the
commit verdicts are held exactly; params, optimizer state, losses and
norms within the tolerance of `test_torch_engine.py` (float32 params atol
1e-5 / rtol 1e-4, losses and norms rtol 1e-4 / atol 1e-6: the frameworks
order float32 sums differently).

Within the port: the fates' rules and rates, the round sum across
``cohort_chunk`` bitwise, over-selection and σ = zS/report_goal, commit iff
accepted ≥ goal, an abort that changes no bit and no later draw, the
accountant counting committed rounds only, and resume (in-process and
through the CLI) bitwise. The reference's own resume is not an oracle
(its bit-exact resume tests fail under this container's jax).
"""
import contextlib
import hashlib
import json
import sys
from dataclasses import asdict

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import DPConfig as JDPConfig
from repro.configs import get_config as jax_get_config
from repro.fl import engine as jeng
from repro.fl import faults as jfaults
from repro.models import build as jax_build
from repro.train import checkpoint as jckpt
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl import engine as eng
from repro_torch.fl.faults import (FaultConfig, FaultFates, fault_fates,
                                   fault_generator)
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.models import build
from repro_torch.train import checkpoint
from repro_torch.utils.params import from_jax_params
from repro_torch.utils.pytree import tree_leaves, tree_map
from test_torch_engine import (SMALL, TINY, RefDraws, _bitwise,
                               _close_trees, _hist_equal)
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

KW = dict(n_users=60, seq_len=6, sentences_per_user=8)
# a mixed stream: at cohort 8 with goal 7 some rounds commit and some abort,
# and corrupt slots appear
MIXED = dict(seed=3, dropout_prob=0.3, straggler_prob=0.2,
             straggler_mean_delay=2.0, round_deadline=3.0, corrupt_prob=0.2)
TINY_MODEL = build(get_config("gboard-cifg-lstm").with_(**TINY))


def _configs(sampling="fixed", sigma=0.3, cohort=8, server_opt="momentum"):
    dpkw = dict(clients_per_round=cohort, noise_multiplier=sigma,
                clip_norm=0.05, server_opt=server_opt, server_lr=0.5,
                server_momentum=0.9, sampling=sampling)
    return dpkw, dict(local_epochs=1, batch_size=4, lr=0.3)


@pytest.fixture(scope="module")
def tiny_ds():
    return FederatedDataset(BigramCorpus(vocab_size=300, seed=0), **KW)


def _engine(ds, sampling="fixed", cohort=8, sigma=0.3, faults=MIXED,
            server_opt="momentum", **kw):
    dpkw, clkw = _configs(sampling, sigma, cohort, server_opt)
    base = dict(n_local_batches=2, availability=1.0, rounds_per_call=3,
                device="cpu")
    base.update(kw)
    fc = None if faults is None else FaultConfig(**faults)
    return eng.SimEngine(TINY_MODEL, ds.to_device_arrays(), DPConfig(**dpkw),
                         ClientConfig(**clkw), fault_config=fc, **base)


def _p0(seed=1):
    return TINY_MODEL.init(torch.Generator().manual_seed(seed), device="cpu")


# ------------------------------------------------ (a) the configuration


@pytest.mark.parametrize("kw", [
    {}, dict(dropout_prob=0.5), dict(dropout_prob=0.1, straggler_prob=0.2,
                                     straggler_mean_delay=1.0,
                                     round_deadline=3.0, corrupt_prob=0.05),
    dict(straggler_prob=0.9, straggler_mean_delay=4.0, round_deadline=0.5),
    dict(dropout_prob=0.3, corrupt_prob=0.3, goal_frac=0.5),
    dict(dropout_prob=0.25, report_goal=30),
    dict(dropout_prob=0.6, over_select=False, goal_frac=1.0)])
def test_fault_config_derived_quantities_equal_the_reference(kw):
    pc, jc = FaultConfig(**kw), jfaults.FaultConfig(**kw)
    assert asdict(pc) == asdict(jc)
    for name in ("late_prob", "on_time_prob", "expected_survival"):
        assert getattr(pc, name) == getattr(jc, name), name
    for target in (1, 8, 32, 128, 1000):
        assert pc.resolve_report_goal(target) == \
            jc.resolve_report_goal(target)
        assert pc.over_selection(target) == jc.over_selection(target)


@pytest.mark.parametrize("kw", [
    dict(dropout_prob=1.0), dict(dropout_prob=-0.1), dict(straggler_prob=1.0),
    dict(corrupt_prob=1.5), dict(straggler_mean_delay=0.0),
    dict(round_deadline=-1.0), dict(goal_frac=0.0), dict(goal_frac=1.5),
    dict(report_goal=0)])
def test_fault_config_validation_matches_the_reference(kw):
    with pytest.raises(ValueError):
        jfaults.FaultConfig(**kw)
    with pytest.raises(ValueError):
        FaultConfig(**kw)


def test_fault_sizing_of_the_full_width_configuration():
    """The fault model chip_smoke's phase 9 runs at cohort 128."""
    fc = FaultConfig(seed=7, dropout_prob=0.1, straggler_prob=0.2,
                     straggler_mean_delay=1.0, round_deadline=3.0,
                     corrupt_prob=0.05)
    assert fc.late_prob == pytest.approx(0.00996, abs=5e-6)
    assert fc.expected_survival == pytest.approx(0.8465, abs=5e-5)
    assert fc.over_selection(128) == 152
    assert fc.resolve_report_goal(128) == 103


# ---------------------------------------------------------- (b) the fates


def test_fates_are_deterministic_and_consistent():
    cfg = FaultConfig(**MIXED)
    f = fault_fates(fault_generator(3, 7), 512, cfg)
    g = fault_fates(fault_generator(3, 7), 512, cfg)
    assert isinstance(f, FaultFates)
    for a, b in zip(f, g):
        assert a.dtype == torch.bool and a.shape == (512,)
        assert torch.equal(a, b)
    rep, cor, dro, late = f
    assert not bool((dro & late).any())       # a dropped slot is never late
    assert not bool((rep & (dro | late)).any())
    assert bool((rep | dro | late).all())     # the fates cover every slot
    assert not bool((cor & ~rep).any())       # corrupt ⇒ reported
    for other in (fault_generator(3, 8), fault_generator(4, 7)):
        assert not torch.equal(fault_fates(other, 512, cfg).reported, rep)


def test_fates_leave_the_training_generator_alone(tiny_ds):
    """The fates come from their own stream: drawing them moves no training
    draw, and the engine's training generator does not change them."""
    cfg = FaultConfig(**MIXED)
    draws = eng.EngineDraws(torch.Generator().manual_seed(0))
    before = draws.generator.get_state()
    a = draws.fates(5, 64, cfg)
    assert torch.equal(draws.generator.get_state(), before)
    other = eng.EngineDraws(torch.Generator().manual_seed(99))
    other.available(1000)
    b = other.fates(5, 64, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_fates_are_monotone_in_dropout():
    prev = torch.zeros(2048, dtype=torch.bool)
    for p in (0.05, 0.2, 0.5, 0.9):
        cur = fault_fates(fault_generator(0, 0), 2048,
                          FaultConfig(dropout_prob=p)).dropped
        assert bool((prev <= cur).all())
        prev = cur


@pytest.mark.parametrize("kw", [
    dict(dropout_prob=0.1, straggler_prob=0.2, straggler_mean_delay=1.0,
         round_deadline=3.0, corrupt_prob=0.05),
    dict(dropout_prob=0.3, straggler_prob=0.5, straggler_mean_delay=2.0,
         round_deadline=1.0, corrupt_prob=0.2)])
def test_fate_rates_within_binomial_bounds(kw):
    n, cfg = 20_000, FaultConfig(**kw)
    rep, cor, dro, late = fault_fates(fault_generator(11, 2), n, cfg)
    rates = {"dropped": (dro, cfg.dropout_prob),
             "late": (late, (1 - cfg.dropout_prob) * cfg.late_prob),
             "reported": (rep, cfg.on_time_prob),
             "corrupt": (cor, cfg.on_time_prob * cfg.corrupt_prob)}
    for name, (got, p) in rates.items():
        sd = np.sqrt(p * (1 - p) / n)
        assert abs(float(got.float().mean()) - p) <= 5 * sd + 1e-12, name


# ------------------------------------------- (c) parity with the reference


class RefFaultDraws(RefDraws):
    """`RefDraws` plus the reference's fault fates for the round."""

    def fates(self, round_idx, n_slots, cfg):
        f = jfaults.fault_fates(jax.random.PRNGKey(cfg.seed), round_idx,
                                n_slots, jfaults.FaultConfig(**asdict(cfg)))
        return FaultFates(*(torch.from_numpy(np.array(a)) for a in f))


_JAX_RUNS = {}
# 48 Poisson slots: blocks of 6, which chunks of 1 and 2 divide
POISSON_BUFFER = 48


def _jax_run(sampling, chunk, K, server_opt="momentum"):
    key = (sampling, chunk, K, server_opt)
    if key not in _JAX_RUNS:
        jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**SMALL))
        from repro.data.corpus import BigramCorpus as JCorpus
        from repro.data.federated import FederatedDataset as JDataset
        jds = JDataset(JCorpus(vocab_size=300, seed=0), **KW)
        dpkw, clkw = _configs(sampling, server_opt=server_opt)
        je = jeng.SimEngine(jm, jds.to_device_arrays(), JDPConfig(**dpkw),
                            JClientConfig(**clkw), n_local_batches=2,
                            availability=0.6 if sampling == "fixed" else 1.0,
                            rounds_per_call=3, cohort_chunk=chunk,
                            poisson_buffer=POISSON_BUFFER,
                            fault_config=jfaults.FaultConfig(**MIXED))
        p0 = jax.tree_util.tree_map(np.asarray, jm.init(
            jax.random.PRNGKey(1)))
        js, jh = je.run_python(je.init_state(jax.tree_util.tree_map(
            jnp.asarray, p0), seed=0), K)
        _JAX_RUNS[key] = (je, p0, js, jh)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("sampling,chunk,server_opt", [
    pytest.param("fixed", 1, "momentum", id="fixed-1"),
    pytest.param("fixed", 2, "momentum", id="fixed-2"),
    pytest.param("poisson", 1, "momentum", id="poisson-1"),
    pytest.param("poisson", 2, "momentum", id="poisson-2"),
    # Adam's bias correction from the step count that commits select on
    # the device
    pytest.param("fixed", 2, "adam", id="fixed-2-adam")])
def test_fault_engine_matches_jax_run_python_with_injected_fates(
        sampling, chunk, server_opt):
    K = 4
    je, p0, js, jh = _jax_run(sampling, chunk, K, server_opt)
    pm = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    pds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), **KW)
    data = pds.to_device_arrays()
    dpkw, clkw = _configs(sampling, server_opt=server_opt)
    pe = eng.SimEngine(pm, data, DPConfig(**dpkw), ClientConfig(**clkw),
                       n_local_batches=2,
                       availability=0.6 if sampling == "fixed" else 1.0,
                       rounds_per_call=3, cohort_chunk=chunk,
                       poisson_buffer=POISSON_BUFFER,
                       fault_config=FaultConfig(**MIXED), device="cpu")
    assert (pe.sel_cohort, pe.padded, pe.buffer, pe.report_goal) == \
        (je.sel_cohort, je.padded, je.buffer, je.report_goal)
    state = pe.init_state(from_jax_params(p0, pm.compute_copies,
                                          device="cpu"),
                          draws=RefFaultDraws(0, data["examples"].shape[1]))
    ps, ph = pe.run_python(state, K)
    for k in ("n_selected", "n_reported", "n_clients", "committed"):
        np.testing.assert_array_equal(ph[k], np.asarray(jh[k]), err_msg=k)
    np.testing.assert_array_equal(ps.participation.numpy(),
                                  np.asarray(js.participation))
    np.testing.assert_array_equal(ps.last_round.numpy(),
                                  np.asarray(js.last_round))
    for k in ("loss", "mean_update_norm", "frac_clipped"):
        np.testing.assert_allclose(ph[k], np.asarray(jh[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(ph["noise_std"], np.asarray(jh["noise_std"]),
                               rtol=1e-6)
    _close_trees(ps.params, js.params)
    _close_trees(ps.opt_state.momentum, js.opt_state.momentum)
    if server_opt == "adam":
        _close_trees(ps.opt_state.nu, js.opt_state.nu)
    assert int(ps.opt_state.count) == int(js.opt_state.count)
    # the stream exercises the protocol: some slots reported late or not at
    # all, and (in the fixed case) both verdicts occur
    assert np.all(ph["n_reported"] < ph["n_selected"])
    if sampling == "fixed":
        assert ph["committed"].any() and not ph["committed"].all()


# ------------------------------------------------- (d)–(g) within the port


@pytest.mark.parametrize("sampling,cohort,chunks", [
    ("fixed", 16, (1, 2, 4)), ("poisson", 12, (1, 3))])
def test_fault_round_sum_is_bitwise_across_cohort_chunk(tiny_ds, sampling,
                                                        cohort, chunks):
    out = []
    for c in chunks:
        e = _engine(tiny_ds, sampling, cohort=cohort, cohort_chunk=c)
        out.append(e.run(e.init_state(_p0(), seed=2), 3))
    s0, h0 = out[0]
    assert "committed" in h0 and np.any(h0["n_reported"] < h0["n_selected"])
    for s, h in out[1:]:
        assert _bitwise(s.params, s0.params)
        assert _bitwise(s.opt_state.momentum, s0.opt_state.momentum)
        _hist_equal(h, h0)


@pytest.mark.parametrize("sampling", ["fixed", "poisson"])
def test_over_selection_sizing_and_sigma_on_the_report_goal(tiny_ds,
                                                            sampling):
    fc = FaultConfig(**MIXED)
    e = _engine(tiny_ds, sampling, cohort=8)
    assert e.report_goal == fc.resolve_report_goal(8) == 7
    assert e.sel_cohort == fc.over_selection(8)
    assert e._round_denom == e.report_goal
    if sampling == "fixed":
        assert e.buffer == e.sel_cohort and e.padded == 16
    else:
        assert e.sel_q == pytest.approx(min(1.0, e.q / fc.expected_survival))
        exp_sel = e.sel_q * e.n_users
        assert e.buffer == e.padded >= exp_sel + 4 * np.sqrt(exp_sel)
    _, h = e.run(e.init_state(_p0()), 2)
    np.testing.assert_allclose(h["noise_std"], 0.3 * 0.05 / 7, rtol=1e-6)
    if sampling == "fixed":
        assert np.all(h["n_selected"] == e.sel_cohort)
    # without over-selection a round is the target cohort
    e2 = _engine(tiny_ds, sampling, cohort=8,
                 faults=dict(MIXED, over_select=False))
    assert e2.sel_cohort == 8 and e2.sel_q == e2.q
    with pytest.warns(UserWarning, match="report_goal"):
        _engine(tiny_ds, sampling, cohort=8, faults=dict(MIXED,
                                                         report_goal=100))


def test_commit_iff_accepted_reaches_the_goal(tiny_ds):
    e = _engine(tiny_ds, cohort=8)
    _, h = e.run(e.init_state(_p0(), seed=1), 6)
    np.testing.assert_array_equal(h["committed"],
                                  h["n_clients"] >= e.report_goal)
    assert np.all(h["n_clients"] <= h["n_reported"])
    assert np.all(h["n_reported"] <= h["n_selected"])
    assert h["committed"].any() and not h["committed"].all()


@pytest.mark.parametrize("server_opt", ["momentum", "adam"])
def test_abort_changes_no_bit_and_no_later_draw(tiny_ds, server_opt):
    """The same round, once aborted (an unreachable goal) and once committed
    (goal 1): the abort leaves params and optimizer state (moments and step
    count) bitwise as they were; both leave the training generator in the
    same state, so every later round draws the same cohorts and noise."""
    out = {}
    for name, goal in (("abort", 100), ("commit", 1)):
        with (pytest.warns(UserWarning, match="report_goal") if goal == 100
              else contextlib.nullcontext()):
            e = _engine(tiny_ds, cohort=8, server_opt=server_opt,
                        faults=dict(MIXED, report_goal=goal))
        state, _ = e.run(e.init_state(_p0(), seed=4), 1)
        st = state.opt_state
        before = [tree_map(torch.clone, t) for t in (state.params,
                                                     st.momentum, st.nu)]
        new, h = e.run(state, 1)
        out[name] = (before, new, h)
    before, new, h = out["abort"]
    assert not h["committed"][0]
    for a, b in zip((new.params, new.opt_state.momentum, new.opt_state.nu),
                    before):
        assert _bitwise(a, b)
    assert int(new.opt_state.count) == 0    # both rounds aborted
    (cb, _, _), cnew, ch = out["commit"]
    assert ch["committed"][0] and not _bitwise(cnew.params, cb)
    assert torch.equal(new.draws.generator.get_state(),
                       cnew.draws.generator.get_state())
    np.testing.assert_array_equal(h["n_reported"], ch["n_reported"])


# ------------------------------------------------------------ (h), (i) trainer


def _trainer(ds, backend="engine", faults=MIXED, cohort=8, draws=None, **kw):
    dpkw, clkw = _configs("fixed", 0.3, cohort)
    pop = PopulationSim(len(ds.users), availability=1.0)
    return FederatedTrainer(
        TINY_MODEL, ds, DPConfig(**dpkw), ClientConfig(**clkw), pop=pop,
        seed=0, n_local_batches=2, backend=backend, rounds_per_call=2,
        device="cpu", draws=draws,
        fault_config=None if faults is None else FaultConfig(**faults), **kw)


def test_trainer_accountant_counts_committed_rounds_only(tiny_ds):
    out = {}
    for backend in ("engine", "engine_python"):
        tr = _trainer(tiny_ds, backend)
        tr.train(5)
        tr.run_round()
        hist = tr.state.history
        committed = sum(r["committed"] for r in hist)
        assert 0 < committed < 6
        assert tr.accountant.rounds == committed
        assert tr.state.round_idx == 6 and len(hist) == 6
        for r in hist:
            assert r["n_clients"] <= r["n_reported"] <= r["n_selected"]
        assert tr.participation.sum() == sum(r["n_reported"] for r in hist)
        out[backend] = tr
    a, b = out["engine"], out["engine_python"]
    assert a.state.history == b.state.history
    assert _bitwise(a.state.params, b.state.params)


def test_host_backend_and_the_materializing_path_refuse_faults(tiny_ds):
    with pytest.raises(ValueError, match="engine-backend"):
        _trainer(tiny_ds, backend="host")
    with pytest.raises(ValueError, match="streaming"):
        _engine(tiny_ds, cohort_chunk=0)
    host = _trainer(tiny_ds, backend="host", faults=None)
    with pytest.raises(ValueError, match="engine-backend"):
        host.save_run_state("unused")


# ------------------------------------------------------------ (j), (k) resume


@pytest.mark.parametrize("faults", [None, MIXED], ids=["faults-off",
                                                       "faults-on"])
def test_save_restore_is_bitwise_the_uninterrupted_run(tiny_ds, tmp_path,
                                                       faults):
    full = _trainer(tiny_ds, faults=faults)
    full.train(6)
    part = _trainer(tiny_ds, faults=faults)
    part.train(3)
    path = tmp_path / "state.msgpack"
    part.save_run_state(path)
    resumed = _trainer(tiny_ds, faults=faults)
    assert resumed.restore_run_state(path) == 3
    assert resumed.accountant.rounds == part.accountant.rounds
    resumed.train(3)
    assert _bitwise(resumed.state.params, full.state.params)
    assert _bitwise(resumed.state.opt_state.momentum,
                    full.state.opt_state.momentum)
    assert resumed.state.history == full.state.history
    assert resumed.accountant.rounds == full.accountant.rounds
    np.testing.assert_array_equal(resumed.participation, full.participation)
    assert torch.equal(resumed._estate.draws.generator.get_state(),
                       full._estate.draws.generator.get_state())
    if faults is not None:
        assert full.accountant.rounds < 6


def test_restore_refuses_another_kind_and_injected_draws(tiny_ds, tmp_path):
    tr = _trainer(tiny_ds)
    ck = tmp_path / "params.msgpack"
    checkpoint.save(ck, tr.state.params, meta={"kind": "params"})
    with pytest.raises(checkpoint.CheckpointError, match="run-state"):
        tr.restore_run_state(ck)
    injected = _trainer(tiny_ds, draws=RefFaultDraws(0, 4))
    with pytest.raises(ValueError, match="EngineDraws"):
        injected.save_run_state(tmp_path / "x.msgpack")


def _cli(out, *extra):
    from repro_torch.launch import train
    return train.main(["--device", "cpu", "--vocab", "300", "--rounds", "4",
                       "--n-users", "40", "--clients-per-round", "8",
                       "--rounds-per-call", "3", "--availability", "1.0",
                       "--out", str(out),
                       *extra])


@pytest.mark.parametrize("fault_args", [
    [], ["--fault-dropout", "0.3", "--fault-straggler", "0.2",
         "--fault-corrupt", "0.1", "--fault-seed", "2"]],
    ids=["faults-off", "faults-on"])
def test_cli_crash_then_resume_gives_the_same_checkpoint(tmp_path, capsys,
                                                         fault_args):
    full = _cli(tmp_path / "full", *fault_args)
    crash = ["--checkpoint-every", "2", *fault_args]
    assert _cli(tmp_path / "cut", *crash, "--crash-after", "2") is None
    assert "simulated crash after round 2" in capsys.readouterr().out
    resumed = _cli(tmp_path / "cut", *crash, "--resume")
    out = capsys.readouterr().out
    assert "resumed from" in out and "at round 2" in out
    digest = [hashlib.sha256(p.read_bytes()).hexdigest()
              for p in (full, resumed)]
    assert digest[0] == digest[1]
    with pytest.raises(SystemExit):
        _cli(tmp_path / "host", "--backend", "host", *crash)


# ------------------------------------------------ (l) the checkpoint reader


def test_checkpoint_load_needs_no_msgpack(tiny_ds, tmp_path, monkeypatch):
    ref = {"layer": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                     "b": np.zeros((4,), np.float32)},
           "w_gates": np.ones((6, 6), np.float32),
           "steps": (np.int32(3), [np.float64(0.5)])}
    jckpt.save(tmp_path / "ref.msgpack", ref, meta={"arch": "x", "n": "2"})
    tr = _trainer(tiny_ds)
    tr.train(1)
    tr.save_run_state(tmp_path / "state.msgpack")
    monkeypatch.setitem(sys.modules, "msgpack", None)
    for name in ("ref.msgpack", "state.msgpack"):
        blob = (tmp_path / name).read_bytes()
        raw = msgpack.unpackb(blob, raw=True, strict_map_key=False)
        assert checkpoint.unpackb(blob) == raw
        tree, meta = checkpoint.load(tmp_path / name)
        want = checkpoint.migrate_lstm_gates(checkpoint._decode(raw[b"tree"]))
        for a, b in zip(_flat(tree), _flat(want)):
            assert a[0] == b[0]
            np.testing.assert_array_equal(a[1], b[1])
        assert meta == {k.decode(): v.decode()
                        for k, v in raw[b"meta"].items()}
    tree, meta = checkpoint.load(tmp_path / "ref.msgpack")
    assert tree["w_x"].shape == (4, 6) and tree["w_h"].shape == (2, 6)
    assert meta == {"arch": "x", "n": "2"}
    state, meta = checkpoint.load(tmp_path / "state.msgpack")
    assert meta["kind"] == "trainer-run-state"
    assert json.loads(meta["history"])[0]["round"] == 1
    blob = (tmp_path / "state.msgpack").read_bytes()
    for name, bad in (("truncated", blob[:-7]), ("trailing", blob + b"\x00"),
                      ("unknown code", b"\xc1" + blob)):
        (tmp_path / name).write_bytes(bad)
        with pytest.raises(checkpoint.CheckpointError):
            checkpoint.load(tmp_path / name)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                      f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{prefix}/{i}")]
    return [(prefix, np.asarray(tree))]
