"""The port's training path against the JAX package's at small widths: the
plain backward cell against the Pallas ``cell_bwd`` (interpreter) and
``jax.vjp`` of ``cifg_step``; ``cifg_sequence``'s forward and time-fused
backward against the reference's; ``loss_fn`` and every gradient for each
cell path; the server optimizers; the accountant; ``FederatedTrainer``
(host backend) round for round from the same seed and parameters; the
checkpoint writer byte for byte; and the training CLI, which imports no JAX.

Tolerances: float32 atol 1e-5 / rtol 1e-4 (the frameworks order float32
sums differently); bfloat16 atol 3e-2 (a one-ulp difference in a float32
sum can flip a bfloat16 rounding). Gradients of a whole model are compared
after dividing both by the reference's largest entry of each leaf, with the
same tolerances.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import DPConfig as JDPConfig
from repro.configs import get_config as jax_get_config
from repro.core import accountant as jacct
from repro.core import server_optim as jopt
from repro.data.corpus import BigramCorpus as JCorpus
from repro.data.federated import FederatedDataset as JDataset
from repro.fl.population import PopulationSim as JPop
from repro.fl.round import FederatedTrainer as JTrainer
from repro.kernels.cifg_cell import cifg_cell as jK
from repro.kernels.cifg_cell import cifg_sequence as jax_sequence
from repro.kernels.cifg_cell import cifg_step as jax_step
from repro.kernels.cifg_cell import ops as jops
from repro.models import build as jax_build
from repro.models.layers import lm_loss as jax_lm_loss
from repro.train import checkpoint as jckpt
from repro.utils.pytree import tree_noise as jax_tree_noise
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.core import accountant as acct
from repro_torch.core import server_optim as opt
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.round import FederatedTrainer
from repro_torch.fl.sampling import sample_round
from repro_torch.kernels.cifg_cell import (LAUNCHES, cell_bwd, cifg_sequence,
                                           cifg_step)
from repro_torch.models import build
from repro_torch.models.layers import lm_loss
from repro_torch.train import checkpoint
from repro_torch.utils.params import from_jax_params, strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_map
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}
SMALL = dict(vocab=300, d_model=32, d_ff=64)


def _close(a, b, dtype, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what,
                               **TOL[dtype])


def _cell_inputs(B, H, seed, S=None):
    rng = np.random.default_rng(seed)
    zx_shape = (B, 3 * H) if S is None else (S, B, 3 * H)
    return [a.astype(np.float32) for a in (
        rng.standard_normal(zx_shape), rng.standard_normal((B, H)) * 0.3,
        rng.standard_normal((B, H)) * 0.3,
        rng.standard_normal((H, 3 * H)) / np.sqrt(H))]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ------------------------------------------------------------------ cell


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(8, 128), (5, 48), (3, 200)])
def test_cell_bwd_plain_matches_jax_pallas_interpret(B, H, dtype):
    """On the Pallas kernel's padded, packed layout; the port's natural
    layout needs no padding."""
    zx, h, c, w = _cell_inputs(B, H, seed=B + H)
    rng = np.random.default_rng(1)
    dh = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    dc = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    Bp, Hp = jops._round_up(B, jK.SUBLANES), jops._round_up(H, jK.LANES)
    zx3, wh3, hp, cp = jops._prep(zx, h, c, w, jnp.dtype(dtype))
    dzx3, dhj, dcj, dwh3 = jK.cell_bwd(zx3, wh3, hp, cp, jops._pad2(dh, Bp, Hp),
                                       jops._pad2(dc, Bp, Hp), interpret=True)
    want = (jops._unpack_gates(dzx3, B, H), dhj[:B, :H], dcj[:B, :H],
            jops._unpack_gates(dwh3, H, H))
    zx_, h_, c_, w_, dh_, dc_ = _t(zx, h, c, w, dh, dc)
    before = LAUNCHES["cifg_cell_bwd"]
    got = cell_bwd(zx_, w_.to(getattr(torch, dtype)), h_, c_, dh_, dc_)
    assert LAUNCHES["cifg_cell_bwd"] == before   # the CPU runs the plain one
    for what, a, b in zip(("dzx", "dh", "dc", "dw_h"), got, want):
        _close(a, b, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cifg_step_grad_matches_jax_vjp(dtype):
    zx, h, c, w = _cell_inputs(5, 48, seed=3)
    rng = np.random.default_rng(4)
    dh = (rng.standard_normal(h.shape) * 0.1).astype(np.float32)
    dc = (rng.standard_normal(h.shape) * 0.1).astype(np.float32)
    (hj, cj), vjp = jax.vjp(
        lambda *a: jax_step(*a, compute_dtype=dtype, interpret=True),
        zx, h, c, w)
    gj = vjp((dh, dc))
    args = [a.requires_grad_(True) for a in _t(zx, h, c, w)]
    hp, cp = cifg_step(*args, compute_dtype=dtype)
    gp = torch.autograd.grad((hp, cp), args, _t(dh, dc))
    _close(hp.detach(), hj, dtype, "h")
    _close(cp.detach(), cj, dtype, "c")
    for what, a, b in zip(("zx", "h", "c", "w_h"), gp, gj):
        _close(a, b, dtype, what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("cell", ["seq", "fused"])
def test_cifg_sequence_matches_jax_vjp(cell, remat, dtype):
    S, B, H = 5, 3, 32
    zx, h0, c0, w = _cell_inputs(B, H, seed=7, S=S)
    rng = np.random.default_rng(8)
    dhs = (rng.standard_normal((S, B, H)) * 0.1).astype(np.float32)
    dhf = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    dcf = (rng.standard_normal((B, H)) * 0.1).astype(np.float32)
    out_j, vjp = jax.vjp(
        lambda *a: jax_sequence(*a, cell=cell, compute_dtype=dtype,
                                remat=remat, interpret=True), zx, h0, c0, w)
    gj = vjp((dhs, (dhf, dcf)))
    args = [a.requires_grad_(True) for a in _t(zx, h0, c0, w)]
    hs, (hf, cf) = cifg_sequence(*args, cell=cell, compute_dtype=dtype,
                                 remat=remat)
    gp = torch.autograd.grad((hs, hf, cf), args, _t(dhs, dhf, dcf))
    _close(hs.detach(), out_j[0], dtype, "hs")
    _close(cf.detach(), out_j[1][1], dtype, "c_fin")
    for what, a, b in zip(("zx", "h0", "c0", "w_h"), gp, gj):
        _close(a, b, dtype, what)
    if remat:   # remat recomputes the same stacks: the same bits
        hs2, (hf2, cf2) = cifg_sequence(*args, cell=cell, compute_dtype=dtype)
        g2 = torch.autograd.grad((hs2, hf2, cf2), args, _t(dhs, dhf, dcf))
        assert all(torch.equal(a, b) for a, b in zip(gp, g2))


# ------------------------------------------------------------------ model


def _pair(dtype, cell, seed=0):
    jcfg = jax_get_config("gboard-cifg-lstm").with_(
        cell_path="seq" if cell == "fused" else cell, compute_dtype=dtype,
        **SMALL)
    pcfg = get_config("gboard-cifg-lstm").with_(
        cell_path=cell, compute_dtype=dtype, **SMALL)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    pm = build(pcfg)
    return jm, jp, pm, from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp), pm.compute_copies,
        device="cpu", compute_dtype=dtype)


def _lm_batch(B=3, S=6, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, 300, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "mask": (rng.random((B, S)) > 0.2).astype(np.float32)}


def test_lm_loss_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((3, 4, 512)).astype(np.float32) * 3
    labels = rng.integers(0, 300, (3, 4)).astype(np.int32)
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = float(jax_lm_loss(logits, labels, 300, m))
        got = float(lm_loss(*_t(logits, labels), 300,
                            None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["ref", "seq", "fused"])
def test_loss_and_every_grad_match_jax(cell, dtype):
    jm, jp, pm, pp, = _pair(dtype, cell)
    batch = _lm_batch()
    lj, gj = jax.value_and_grad(jm.loss_fn)(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    # the compute copies from_jax_params made are ignored by loss_fn
    leaves = tree_leaves(strip_compute(pp))
    for l in leaves:
        l.requires_grad_(True)
    lp = pm.loss_fn(pp, {k: torch.from_numpy(v) for k, v in batch.items()})
    gp = torch.autograd.grad(lp, leaves)
    _close(float(lp.detach()), float(lj), dtype, "loss")
    for a, b in zip(gp, jax.tree_util.tree_leaves(gj)):
        b = np.asarray(b, np.float32)
        scale = max(float(np.abs(b).max()), 1e-30)
        _close(a.numpy() / scale, b / scale, dtype, "grad")


def test_remat_grads_are_bitwise_those_without():
    for cell in ("ref", "seq"):
        _, _, pm, pp = _pair("float32", cell)
        batch = {k: torch.from_numpy(v) for k, v in _lm_batch().items()}
        params = strip_compute(pp)
        leaves = tree_leaves(params)
        for l in leaves:
            l.requires_grad_(True)
        from repro_torch.models import lstm
        g1 = torch.autograd.grad(lstm.loss_fn(params, batch, pm.cfg), leaves)
        g2 = torch.autograd.grad(
            lstm.loss_fn(params, batch, pm.cfg, remat=True), leaves)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))


# ------------------------------------------------------- server and DP


@pytest.mark.parametrize("server_opt,nesterov", [
    ("sgd", True), ("momentum", True), ("momentum", False), ("adam", True)])
def test_apply_update_matches_jax(server_opt, nesterov):
    rng = np.random.default_rng(9)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32)}}
    jdp = JDPConfig(server_opt=server_opt, nesterov=nesterov, server_lr=0.7,
                    server_momentum=0.9)
    pdp = DPConfig(server_opt=server_opt, nesterov=nesterov, server_lr=0.7,
                   server_momentum=0.9)
    jp, js = params, jopt.init_state(params)
    pp = tree_map(torch.from_numpy, params)
    ps = opt.init_state(pp)
    for step in range(3):
        delta = {"a": rng.standard_normal((4, 3)).astype(np.float32) * 0.1,
                 "b": {"c": rng.standard_normal(5).astype(np.float32) * 0.1}}
        jp, js = jopt.apply_update(jp, delta, js, jdp)
        pp, ps = opt.apply_update(pp, tree_map(torch.from_numpy, delta), ps,
                                  pdp)
        assert ps.count == int(js.count) == step + 1
    for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
    with pytest.raises(ValueError):
        opt.apply_update(pp, pp, ps, DPConfig(server_opt="lamb"))


@pytest.mark.parametrize("population", [1_000_000, 4_000_000, 10_000_000])
def test_accountant_matches_jax(population):
    assert acct.table5_epsilon(population) == jacct.table5_epsilon(population)
    for sampling in ("poisson", "wor"):
        a = acct.MomentsAccountant(q=0.01, noise_multiplier=0.8,
                                   sampling=sampling)
        b = jacct.MomentsAccountant(q=0.01, noise_multiplier=0.8,
                                    sampling=sampling)
        a.step(100)
        b.step(100)
        assert a.get_epsilon(1e-6) == b.get_epsilon(1e-6)


def test_aggregate_matches_jax_without_noise():
    from repro.core.dp_fedavg import aggregate as jaggregate
    from repro_torch.core.dp_fedavg import aggregate

    rng = np.random.default_rng(12)
    ups = [{"a": (rng.standard_normal((3, 4)) * s).astype(np.float32),
            "b": (rng.standard_normal(6) * s).astype(np.float32)}
           for s in (0.1, 1.0, 3.0)]
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *ups)
    dp = dict(clip_norm=1.5, noise_multiplier=0.0)
    jmean, jstats = jaggregate(stacked, jax.random.PRNGKey(0),
                               JDPConfig(**dp))
    pmean, pstats = aggregate([tree_map(torch.from_numpy, u) for u in ups],
                              torch.Generator(), DPConfig(**dp))
    for a, b in zip(tree_leaves(pmean), jax.tree_util.tree_leaves(jmean)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=1e-5)
    np.testing.assert_allclose(float(pstats.mean_update_norm),
                               float(jstats.mean_update_norm), rtol=1e-5)
    assert float(pstats.frac_clipped) == float(jstats.frac_clipped)
    assert float(pstats.frac_clipped) == pytest.approx(2 / 3)


def test_configs_match_jax_field_for_field():
    import dataclasses

    for ours, theirs in ((DPConfig(), JDPConfig()),
                         (ClientConfig(), JClientConfig())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for arch in ("zamba2-2.7b", "mamba2-370m"):
        ours, theirs = get_config(arch), jax_get_config(arch)
        for o, t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
            assert dataclasses.asdict(o) == dataclasses.asdict(t)
            assert o.head_dim == t.head_dim


# ------------------------------------------------------------- trainer


def _trainers(sigma, seed=0):
    """The reference's host trainer and the port's on one seed, the port
    starting from the reference's parameters, float32 products."""
    cfg = dict(SMALL, compute_dtype="float32", cell_path="seq")
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**cfg))
    pm = build(get_config("gboard-cifg-lstm").with_(**cfg))
    kw = dict(n_users=40, seq_len=6, sentences_per_user=8)
    jds = JDataset(JCorpus(vocab_size=300, seed=seed), **kw)
    pds = FederatedDataset(BigramCorpus(vocab_size=300, seed=seed), **kw)
    dpkw = dict(clients_per_round=8, noise_multiplier=sigma, clip_norm=0.05,
                server_opt="momentum", server_lr=0.5, server_momentum=0.9)
    clkw = dict(local_epochs=1, batch_size=4, lr=0.3)
    jt = JTrainer(jm, jds, JDPConfig(**dpkw), JClientConfig(**clkw),
                  pop=JPop(40, availability=0.6, seed=seed), seed=seed,
                  n_local_batches=2, backend="host")
    params0 = jax.tree_util.tree_map(np.asarray, jt.state.params)
    keys = {"key": jax.random.PRNGKey(seed)}

    def reference_noise(round_idx, like, std):
        # the reference's draw: split the trainer key, tree_noise(sub, ...)
        keys["key"], sub = jax.random.split(keys["key"])
        shapes = jax.tree_util.tree_map(
            lambda l: np.zeros(l.shape, np.float32), like)
        return tree_map(lambda l: torch.from_numpy(np.array(l)),
                        jax_tree_noise(sub, shapes, std))

    pt = FederatedTrainer(pm, pds, DPConfig(**dpkw), ClientConfig(**clkw),
                          pop=PopulationSim(40, availability=0.6, seed=seed),
                          seed=seed, n_local_batches=2,
                          params=from_jax_params(params0, pm.compute_copies,
                                                 device="cpu"),
                          device="cpu", noise_fn=reference_noise)
    return jt, pt


@pytest.mark.parametrize("sigma", [0.0, 0.3])
def test_trainer_matches_jax_round_for_round(sigma):
    jt, pt = _trainers(sigma)
    for _ in range(2):
        jr, pr = jt.run_round(), pt.run_round()
        np.testing.assert_array_equal(pt.participation, jt.participation)
        assert pr["n_clients"] == jr["n_clients"]
        for k in ("loss", "mean_update_norm", "frac_clipped", "noise_std"):
            np.testing.assert_allclose(pr[k], jr[k], rtol=1e-4, atol=1e-6)
    for a, b in zip(tree_leaves(pt.state.params),
                    jax.tree_util.tree_leaves(jt.state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-4)
    assert pt.accountant.get_epsilon(1e-6) == jt.accountant.get_epsilon(1e-6)


def test_trainer_noise_has_the_calibrated_std_and_engines_raise():
    _, pt = _trainers(0.3)
    pt.noise_fn = None
    from repro_torch.core.dp_fedavg import finalize_round

    zeros = tree_map(torch.zeros_like, pt.state.params)
    noised, stats = finalize_round(zeros, 8, pt.generator, pt.dp)
    flat = torch.cat([l.reshape(-1) for l in tree_leaves(noised)])
    assert stats.noise_std == pytest.approx(0.3 * 0.05 / 8)
    assert float(flat.std()) == pytest.approx(stats.noise_std, rel=0.02)
    # the engine backends are ported; shards need as many ranks, and the
    # host backend refuses them
    with pytest.raises(ValueError, match="--nproc-per-node 2"):
        FederatedTrainer(pt.model, pt.dataset, pt.dp, pt.client,
                         backend="engine", num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="engine-backend"):
        FederatedTrainer(pt.model, pt.dataset, pt.dp, pt.client,
                         backend="host", num_shards=2)


def test_data_and_sampling_are_the_references_bits():
    jds = JDataset(JCorpus(vocab_size=300, seed=3), n_users=12, seq_len=6,
                   sentences_per_user=5)
    pds = FederatedDataset(BigramCorpus(vocab_size=300, seed=3), n_users=12,
                           seq_len=6, sentences_per_user=5)
    for u in range(12):
        np.testing.assert_array_equal(jds.users[u].examples,
                                      pds.users[u].examples)
    jrng, prng = np.random.default_rng(4), np.random.default_rng(4)
    jpop, ppop = JPop(12, availability=0.7, seed=5), PopulationSim(
        12, availability=0.7, seed=5)
    from repro.fl.sampling import sample_round as jsample
    for r in range(3):
        ids = sample_round(ppop, prng, r, 4)
        np.testing.assert_array_equal(ids, jsample(jpop, jrng, r, 4))
        want = jds.user_tensor(int(ids[0]), 3, 2, jrng)
        for k, v in pds.user_tensor(int(ids[0]), 3, 2, prng).items():
            np.testing.assert_array_equal(v, want[k])


# ------------------------------------------------- checkpoint and the CLI


def test_checkpoint_save_is_byte_identical_to_the_reference(tmp_path):
    _, _, _, pp = _pair("bfloat16", "seq")
    tree = {k: v for k, v in pp.items() if k != "compute"}
    meta = {"arch": "gboard-cifg-lstm", "rounds": "2", "eps@1e-6": "1.234"}
    jckpt.save(tmp_path / "ref.msgpack", tree_map(lambda l: l.numpy(), tree),
               meta=meta)
    checkpoint.save(tmp_path / "port.msgpack", pp, meta=meta)
    assert (tmp_path / "port.msgpack").read_bytes() == \
        (tmp_path / "ref.msgpack").read_bytes()
    loaded, m = checkpoint.load(tmp_path / "port.msgpack")
    assert m == meta and set(loaded) == set(tree)
    assert not list(tmp_path.glob(".*tmp*"))   # the temp file was renamed
    # sequences, integer leaves and long strings take the format's other
    # encodings
    other = {"z": (np.arange(300, dtype=np.int64), [np.float32(2.5)]),
             "a": np.zeros((0, 3), np.int32)}
    meta = {"history": "x" * 70000, "k": "y" * 40}
    jckpt.save(tmp_path / "ref2", other, meta=meta)
    checkpoint.save(tmp_path / "port2", other, meta=meta)
    assert (tmp_path / "port2").read_bytes() == \
        (tmp_path / "ref2").read_bytes()


def test_training_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    ck = train.main(["--device", "cpu", "--vocab", "300", "--rounds", "2",
                     "--n-users", "60", "--clients-per-round", "8",
                     "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "round    2" in out and "eps=" in out and f"checkpoint: {ck}" in out
    tree, meta = checkpoint.load(ck)
    assert meta["rounds"] == "2" and tree["w_h"].shape == (256, 768)


def test_training_cli_imports_no_jax():
    code = ("import sys, repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'msgpack')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
