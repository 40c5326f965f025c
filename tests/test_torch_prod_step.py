"""The production train step on one rank
(`repro_torch.launch.steps.make_fed_train_step` on a (1, 1) mesh of one
gloo rank) against the reference's ``make_fed_train_step``, run unchanged
on a 1 × 1 mesh built with ``axis_types=(AxisType.Auto,) * 2`` (jax 0.9's
default Explicit axes turn the step's ``with_sharding_constraint`` into an
assert), for every family at ``.reduced()``: the same params (carried
across with ``from_jax_params``), the same tokens, z 0.

Tolerances: the compute copies are bfloat16 in both, and the two
frameworks round the products at other places, so the per-client
gradients differ at bfloat16's resolution. Per leaf, the update of the
params (and the momentum) agrees within ``REF_TOL`` of the leaf's largest
update; the loss and the mean update norm within 2e-3 relative;
``frac_clipped`` exactly. A planted fault — the clip factor left out, or
plain momentum in place of Nesterov — reads far above ``REF_TOL``.

Within the port the (1, 1) step is bitwise `steps.fed_train_step_plain`,
the same computation with no mesh (for the families the card runs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import DPConfig as JDP
from repro.configs import MeshConfig as JMC
from repro.configs import get_config as jget
from repro.configs.base import InputShape as JIS
from repro.core.server_optim import init_state as jinit
from repro.launch import steps as JST
from repro.models import build as jbuild
from repro.sharding import specs as JSP
from repro.utils import compat
from repro_torch.configs import DPConfig, InputShape, MeshConfig, get_config
from repro_torch.core.server_optim import init_state
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh, one_rank
from repro_torch.models import build
from repro_torch.sharding import specs as SP
from repro_torch.utils.params import from_jax_params, strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_map
# importing the autouse fixture `_one_thread` runs this file's tests on one
# torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

# |Δ_port − Δ_ref| <= REF_TOL · max|Δ_ref| per leaf (bfloat16 gradients
# rounded at other places by the two frameworks; 3.5% measured worst, on
# zamba2's reduced config)
REF_TOL = 5e-2

FAMILIES = ["granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
            "whisper-small", "chameleon-34b", "gboard-cifg-lstm"]
# the families phase 15 of chip_smoke.py trains on the card
BITWISE = ("granite-3-2b", "mamba2-370m", "gboard-cifg-lstm")

C, S = 2, 16
CLIP = 0.8


def assert_updates_close(got, want, start, tol, what):
    """Leaf by leaf, ``got - start`` against ``want - start`` (``start``
    None: the leaves themselves) within ``tol`` of the largest
    ``|want - start|``."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if start is not None:
            s = np.asarray(start[i], np.float64)
            g, w = g - s, w - s
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= tol * scale, (what, i, err, scale)


def _batch(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (C, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (C, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["image_embeds"] = rng.standard_normal(
            (C, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _reference(arch: str):
    jm = jbuild(jget(arch).reduced())
    params = jm.init(jax.random.PRNGKey(0))
    batch = _batch(jm.cfg)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    mcfg = JMC((1, 1), ("data", "model"))
    pspecs = JSP.param_specs(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                             jm.cfg, mcfg)
    with compat.set_mesh(mesh):
        fn = JST.make_fed_train_step(
            jm, JDP(clients_per_round=C, noise_multiplier=0.0,
                    clip_norm=CLIP), mesh, mcfg, pspecs,
            JIS("tiny_train", S, C, "train"), donate=False)
        new_p, new_s, metrics = fn(
            params, jinit(params),
            {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(2))
    leaves = lambda t: [np.asarray(l) for l in jax.tree_util.tree_leaves(t)]
    return (params, batch, leaves(params), leaves(new_p),
            leaves(new_s.momentum), {k: float(v) for k, v in metrics.items()})


def _port_step(arch: str, jparams, batch):
    cfg = get_config(arch).reduced()
    model = build(cfg)
    p0 = strip_compute(from_jax_params(jparams, model.compute_copies,
                                       device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    dp = DPConfig(clients_per_round=C, noise_multiplier=0.0, clip_norm=CLIP)
    mcfg = MeshConfig((1, 1), ("data", "model"))
    with one_rank(device="cpu"):
        mesh = make_production_mesh(shape=(1, 1), device_type="cpu")
        pspecs = SP.param_specs(ST.params_shape(model), cfg, mcfg)
        st = init_state(p0)
        st = st._replace(momentum=SP.distribute_params(st.momentum, pspecs,
                                                       mesh))
        step = ST.make_fed_train_step(model, dp, mesh, mcfg, pspecs,
                                      InputShape("tiny_train", S, C,
                                                 "train"))
        params, st, metrics = step(SP.distribute_params(p0, pspecs, mesh),
                                   st, tb, torch.Generator().manual_seed(0))
        params = SP.gather_params(params)
        momentum = SP.gather_params(st.momentum)
    return model, p0, tb, dp, params, momentum, st, metrics


@pytest.fixture(scope="module")
def granite():
    """granite-3-2b's reference run and the port's inputs, for the planted
    faults."""
    return _reference("granite-3-2b")


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_rank_step_matches_the_reference_step(arch):
    jparams, batch, p0, want_p, want_m, want = _reference(arch)
    model, p0t, tb, dp, params, momentum, st, metrics = _port_step(
        arch, jparams, batch)
    got = {k: float(v) for k, v in metrics.items()}
    assert got["frac_clipped"] == want["frac_clipped"]
    assert got["noise_std"] == want["noise_std"] == 0.0
    for k in ("loss", "mean_update_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, err_msg=k)
    assert st.count == 1
    assert_updates_close(tree_leaves(params), want_p, p0, REF_TOL, "params")
    assert_updates_close(tree_leaves(momentum), want_m, None, REF_TOL,
                         "momentum")
    if arch in BITWISE:
        # the (1, 1) mesh is bitwise the computation with no mesh
        pp, ps, pm = ST.fed_train_step_plain(
            model, dp, tree_map(torch.clone, p0t), init_state(p0t), tb,
            torch.Generator().manual_seed(0))
        for a, b in zip(tree_leaves(pp), tree_leaves(params)):
            assert torch.equal(a, b)
        for a, b in zip(tree_leaves(ps.momentum), tree_leaves(momentum)):
            assert torch.equal(a, b)
        for k in got:
            assert float(pm[k]) == got[k], k


@pytest.mark.parametrize("fault", ["no clip factor", "plain momentum"])
def test_a_planted_fault_reads_above_the_tolerance(granite, fault,
                                                   monkeypatch):
    jparams, batch, p0, want_p, _, want = granite
    assert want["frac_clipped"] == 1.0   # every client is clipped
    if fault == "no clip factor":
        clip = ST._clip
        monkeypatch.setattr(ST, "_clip", lambda ss, S, lr: clip(ss, 1e30, lr))
    else:
        def plain_momentum(p, m, d, dp):
            m.mul_(dp.server_momentum).add_(d)
            return p.add_(dp.server_lr * m), m
        monkeypatch.setattr(ST, "_server_leaf", plain_momentum)
    params = _port_step("granite-3-2b", jparams, batch)[4]
    with pytest.raises(AssertionError):
        assert_updates_close(tree_leaves(params), want_p, p0, REF_TOL,
                             "params")
