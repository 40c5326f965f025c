"""The production step across ranks: `repro_torch.launch.steps` on 4 gloo
ranks in processes (`repro_torch.launch.mesh.spawn_ranks`), one spawn for
the three topologies, every case of each in it (the ranks import
`torch_step_ranks`, which imports no JAX).

* The train step at (data 2, model 2), at (pod 2, data 1, model 2) and at
  (data 1, model 4) against the port's own (1, 1) step, within
  ``RANKS_TOL``: the model axis splits the bfloat16 contractions (partial
  sums rounded before the all-reduce), so the updates differ at bfloat16's
  resolution and not bitwise. The (1, 4) case has 2 KV heads, which do not
  divide the model axis (the reshape to heads reshards, the decode cache
  is sequence-sharded), and noise z 0.3: the noise is drawn at the full
  leaf shape on every rank, so it is the same whatever the layout. There
  the updates are compared with the known noise σ·N taken out of both
  (`_noise_offsets`), so that the tolerance is a share of the clipped
  gradients' sum, which the noise would otherwise swamp.
* granite-3-2b and olmoe-1b-7b at (2, 2) against the reference's
  ``make_fed_train_step`` on a 2 × 2 mesh of 4 forced host devices (a
  subprocess; the mesh Auto-typed, params, opt state, batch and key placed
  with ``jax.device_put`` at the step's in-shardings), z 0, within
  `test_torch_prod_step.REF_TOL`.
* The prefill and decode steps: on one rank bitwise the unsharded
  ``prefill`` / ``decode_step``; on 4 ranks within ``SERVE_TOL`` of the
  largest logit (bfloat16 partial sums again).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_step_ranks as sr
from repro_torch.configs import DPConfig
from repro_torch.launch.mesh import one_rank, spawn_ranks
from repro_torch.utils.pytree import tree_leaves
# importing the autouse fixture `_one_thread` runs this file's tests on one
# torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401
from test_torch_prod_step import REF_TOL, assert_updates_close

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

# |Δ_mesh − Δ_(1,1)| <= RANKS_TOL · max|Δ_(1,1)| per leaf: the bfloat16
# contractions split over the model axis (each partial rounded, then
# summed), so the clipped gradients differ at bfloat16's resolution, as
# against the reference (REF_TOL)
RANKS_TOL = 5e-2
# the serving steps' logits on 4 ranks: 2e-2 of the largest logit, the
# port's bfloat16 logit tolerance (test_torch_transformer.py)
SERVE_TOL = 2e-2

TOPOLOGIES = {
    "2x2": ((2, 2), ("data", "model"), ("granite", "olmoe")),
    "2x1x2": ((2, 1, 2), ("pod", "data", "model"), ("granite-train",)),
    "1x4-kv2": ((1, 4), ("data", "model"), ("granite-kv2",)),
}
ARCH = {"granite": ("granite-3-2b", None, 0.0),
        "olmoe": ("olmoe-1b-7b", None, 0.0),
        "granite-kv2": ("granite-3-2b", 2, 0.3)}
REF_CASES = ("granite", "olmoe")
# the (2, 1, 2) spawn runs granite's train step only
ALIASES = {"granite-train": "granite"}


def _tokens(vocab: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (sr.C, sr.S + sr.DECODE + 1)
                        ).astype(np.int32)


def _reference_params(arch: str):
    import jax

    from repro.configs import get_config as jget
    from repro.models import build as jbuild
    jm = jbuild(jget(arch).reduced())
    return jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))


def _cases():
    out = {}
    for name, (arch, kv, z) in ARCH.items():
        params = (_reference_params(arch) if name in REF_CASES
                  else sr.init_params(arch, kv))
        vocab = sr.config(arch, kv).vocab
        out[name] = sr.case(name, arch, params, _tokens(vocab, len(out)),
                            z=z, kv=kv)
    return out


def _reference_main(out_path: str) -> None:
    """The reference's step on a 2 × 2 mesh of 4 forced host devices (run
    in a subprocess: the device count is fixed when jax starts)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import DPConfig as JDP
    from repro.configs import MeshConfig as JMC
    from repro.configs import get_config as jget
    from repro.configs.base import InputShape as JIS
    from repro.core.server_optim import ServerOptState, init_state
    from repro.launch import steps as JST
    from repro.models import build as jbuild
    from repro.sharding import specs as JSP
    from repro.utils import compat

    assert len(jax.devices()) == 4
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    mcfg = JMC((2, 2), ("data", "model"))
    shape = JIS("tiny_train", sr.S, sr.C, "train")
    out = {}
    for i, name in enumerate(REF_CASES):
        arch = ARCH[name][0]
        jm = jbuild(jget(arch).reduced())
        params = jm.init(jax.random.PRNGKey(0))
        toks = _tokens(jm.cfg.vocab, i)
        batch = {"tokens": toks[:, :sr.S], "labels": toks[:, 1:sr.S + 1]}
        pspecs = JSP.param_specs(jax.eval_shape(jm.init,
                                                jax.random.PRNGKey(0)),
                                 jm.cfg, mcfg)
        bspecs = JSP.batch_specs(jm.cfg, shape, mcfg)
        put = lambda tree, specs: jax.tree_util.tree_map(
            lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
            tree, specs)
        with compat.set_mesh(mesh):
            fn = JST.make_fed_train_step(
                jm, JDP(clients_per_round=sr.C, noise_multiplier=0.0,
                        clip_norm=0.8), mesh, mcfg, pspecs, shape,
                donate=False)
            opt_specs = ServerOptState(momentum=pspecs, nu=pspecs,
                                       count=P())
            new_p, new_s, metrics = fn(
                put(params, pspecs), put(init_state(params), opt_specs),
                put({k: jnp.asarray(v) for k, v in batch.items()}, bspecs),
                jax.device_put(jax.random.PRNGKey(2),
                               NamedSharding(mesh, P())))
        for j, l in enumerate(jax.tree_util.tree_leaves(new_p)):
            out[f"{name}/params/{j}"] = np.asarray(l)
        for j, l in enumerate(jax.tree_util.tree_leaves(new_s.momentum)):
            out[f"{name}/momentum/{j}"] = np.asarray(l)
        for k, v in metrics.items():
            out[f"{name}/metrics/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


def _noise_offsets(c):
    """The noise part of a case's one step from zero momentum, as
    (params, momentum) leaves: the step draws N(0, 1) leaf by leaf in tree
    order from `torch_step_ranks.NOISE_SEED` at σ = zS/C, so d = g + σN,
    m′ = d and p′ − p = lr_s(1 + μ)d. Added to the starting point, they
    leave Δ its clipped gradients alone."""
    dp = DPConfig()
    gen = torch.Generator().manual_seed(sr.NOISE_SEED)
    sigma = c["z"] * sr.CLIP / sr.C
    noise = [sigma * torch.randn(np.shape(l), generator=gen,
                                 dtype=torch.float32).double().numpy()
             for l in tree_leaves(c["params"])]
    coef = dp.server_lr * (1 + dp.server_momentum)
    return ([np.asarray(l, np.float64) + coef * n
             for l, n in zip(tree_leaves(c["params"]), noise)], noise)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 2 × 2 runs, started in a subprocess at once so that
    they run beside the port's spawns."""
    npz = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(npz)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, npz
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def runs(reference):
    """Every topology's spawn, and the (1, 1) run of every case in this
    process."""
    cases = _cases()
    with one_rank(device="cpu"):
        one = sr.run_cases(CPU, (1, 1), ("data", "model"),
                           list(cases.values()))
    for alias, name in ALIASES.items():
        cases[alias] = dict(cases[name], name=alias, serve=False)
        one[alias] = one[name]
    plan = {topo: (shape, axes, [cases[n] for n in names])
            for topo, (shape, axes, names) in TOPOLOGIES.items()}
    per_rank = spawn_ranks(sr.run_topologies, 4, (plan,), backend="gloo",
                           device="cpu")
    ranks = {topo: [r[topo] for r in per_rank] for topo in TOPOLOGIES}
    return cases, one, ranks


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_train_step_across_ranks_matches_one_rank(runs, topo):
    cases, one, ranks = runs
    for name in TOPOLOGIES[topo][2]:
        got = [r[name] for r in ranks[topo]]
        for other in got[1:]:      # every rank ends with the same tensors
            for a, b in zip(tree_leaves(got[0]["params"]),
                            tree_leaves(other["params"])):
                np.testing.assert_array_equal(a, b)
        want = one[name]
        p_start, m_start = _noise_offsets(cases[name])
        assert got[0]["count"] == want["count"] == 1
        assert got[0]["metrics"]["frac_clipped"] == \
            want["metrics"]["frac_clipped"]
        for k in ("loss", "mean_update_norm", "noise_std"):
            np.testing.assert_allclose(got[0]["metrics"][k],
                                       want["metrics"][k], rtol=1e-3,
                                       err_msg=f"{topo} {name} {k}")
        assert_updates_close(tree_leaves(got[0]["params"]),
                             tree_leaves(want["params"]), p_start,
                             RANKS_TOL, f"{topo} {name} params")
        assert_updates_close(tree_leaves(got[0]["momentum"]),
                             tree_leaves(want["momentum"]), m_start,
                             RANKS_TOL, f"{topo} {name} momentum")


@pytest.mark.parametrize("name", REF_CASES)
def test_train_step_across_ranks_matches_the_reference_2x2(runs, reference,
                                                           name):
    cases, _, ranks = runs
    proc, npz = reference
    log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log[-4000:]
    want = np.load(npz)
    got = ranks["2x2"][0][name]
    n = len(tree_leaves(got["params"]))
    assert got["metrics"]["frac_clipped"] == float(
        want[f"{name}/metrics/frac_clipped"])
    for k in ("loss", "mean_update_norm"):
        np.testing.assert_allclose(got["metrics"][k],
                                   float(want[f"{name}/metrics/{k}"]),
                                   rtol=2e-3, err_msg=f"{name} {k}")
    assert_updates_close(
        tree_leaves(got["params"]),
        [want[f"{name}/params/{j}"] for j in range(n)],
        tree_leaves(cases[name]["params"]), REF_TOL, f"{name} params")
    assert_updates_close(
        tree_leaves(got["momentum"]),
        [want[f"{name}/momentum/{j}"] for j in range(n)], None, REF_TOL,
        f"{name} momentum")


def test_serving_steps_on_one_rank_are_the_unsharded_steps(runs):
    cases, one, _ = runs
    for name, c in cases.items():
        if not c["serve"]:
            continue
        want = sr.serve_unsharded(c["arch"], c["params"], c["tokens"],
                                  c["kv"])
        for a, b in zip(one[name]["logits"], want):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
def test_serving_steps_across_ranks_match_the_unsharded_steps(runs, topo):
    cases, _, ranks = runs
    for name in TOPOLOGIES[topo][2]:
        c = cases[name]
        if not c["serve"]:
            continue
        want = sr.serve_unsharded(c["arch"], c["params"], c["tokens"],
                                  c["kv"])
        for r in ranks[topo]:
            for i, (a, b) in enumerate(zip(r[name]["logits"], want)):
                assert a.shape == b.shape
                err = np.abs(a - b).max() / np.abs(b).max()
                assert err <= SERVE_TOL, (topo, name, i, err)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
