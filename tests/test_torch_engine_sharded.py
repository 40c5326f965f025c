"""The port's engine with the cohort sharded over ranks
(`repro_torch.fl.engine.SimEngine(num_shards=S, num_pods=P)`), run in
processes on gloo on the CPU (`repro_torch.launch.mesh.spawn_ranks`).

Within the port, bitwise: at (P, S) = (1, 2), (1, 4) and (2, 2) every rank
ends with the params, momentum, whole population vectors and history of
the one-rank engine, for fixed rounds at σ 0 and 0.3, Poisson rounds, the
fault model, the sharded sampler (fixed and Poisson), the streamed
backend, ``cohort_chunk`` 1, auto and 0 (one spawn a topology runs every
configuration). The ranks import `torch_sharded_ranks`, which imports no
JAX.

Against the reference: its shard_map engine (`repro.fl.engine.SimEngine`)
at ``num_shards=4`` and at ``num_pods=2, num_shards=2`` on 4 forced host
devices, in a subprocess, σ 0, fixed rounds, device backend, the global
and the sharded sampler. The parent records the reference's draws
(`test_torch_engine.RefDraws`, `test_torch_streamed.RefBlockDraws`) as
tensors, and the port's ranks replay them (`torch_sharded_ranks.
ReplayDraws`). Cohorts, participation and round sizes exactly; params,
momentum, losses and norms within `test_torch_engine.py`'s tolerance
(float32 params atol 1e-5 / rtol 1e-4, losses and norms rtol 1e-4 / atol
1e-6: the frameworks order float32 sums differently).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_ranks as tr
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.utils.pytree import tree_leaves
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]

SPECS = [
    tr.run_spec("fixed z0"),
    tr.run_spec("fixed z0.3 chunk1", sigma=0.3, chunk=1),
    tr.run_spec("fixed z0.3 chunk0", sigma=0.3, chunk=0),
    tr.run_spec("poisson z0.3", "poisson", sigma=0.3),
    tr.run_spec("faults", sigma=0.3, faults=True),
    tr.run_spec("faults poisson chunk1", "poisson", faults=True, chunk=1),
    tr.run_spec("sharded fixed", sampler="sharded", sigma=0.3),
    tr.run_spec("sharded poisson chunk1", "poisson", sampler="sharded",
                chunk=1),
    tr.run_spec("streamed", backend="streamed", sigma=0.3),
    tr.run_spec("streamed sharded poisson faults", "poisson",
                sampler="sharded", backend="streamed", faults=True),
]

# the reference's runs: σ 0, fixed rounds, device backend, 2 rounds
K_REF = 2
REFERENCE_RUNS = [((1, 4), "global"), ((1, 4), "sharded"),
                  ((2, 2), "global"), ((2, 2), "sharded")]


def _reference_main(out_path: str) -> None:
    """The reference's sharded engine on 4 forced host devices (run in a
    subprocess: the device count is fixed when jax starts)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import ClientConfig as JClientConfig
    from repro.configs import DPConfig as JDPConfig
    from repro.configs import get_config as jax_get_config
    from repro.data.corpus import BigramCorpus as JCorpus
    from repro.data.federated import FederatedDataset as JDataset
    from repro.fl import engine as jeng
    from repro.models import build as jax_build

    assert len(jax.devices()) == 4
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**tr.MODEL))
    data = JDataset(JCorpus(vocab_size=300, seed=0),
                    **tr.DATA).to_device_arrays()
    p0 = jm.init(jax.random.PRNGKey(1))
    out = {}
    for (pods, shards), sampler in REFERENCE_RUNS:
        # run donates its state: a copy of p0 each
        state = jax.tree_util.tree_map(jnp.array, p0)
        je = jeng.SimEngine(
            jm, data, JDPConfig(noise_multiplier=0.0, sampling="fixed",
                                **tr.DP),
            JClientConfig(**tr.CLIENT), **tr.ENGINE,
            availability=tr.availability("fixed"), num_pods=pods,
            num_shards=shards, sampler=sampler)
        assert je.total_shards == 4 and je.mesh is not None
        js, jh = je.run(je.init_state(state, seed=0), K_REF)
        key = f"{pods}x{shards}/{sampler}"
        for i, l in enumerate(jax.tree_util.tree_leaves(js.params)):
            out[f"{key}/params/{i}"] = np.asarray(l)
        for i, l in enumerate(jax.tree_util.tree_leaves(
                js.opt_state.momentum)):
            out[f"{key}/momentum/{i}"] = np.asarray(l)
        for k in ("participation", "last_round"):
            out[f"{key}/{k}"] = np.asarray(getattr(js, k))
        for k, v in jh.items():
            out[f"{key}/hist/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, started in a subprocess at once so that they
    run beside the port's: the process and the file it writes."""
    npz = tmp_path_factory.mktemp("reference") / "reference.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(npz)], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    yield proc, npz
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _replay_specs():
    """The reference's draws for its runs, recorded through the port's
    one-rank engine (`RefDraws` rebuilds its key chain, `RefBlockDraws`
    adds its block draws), as configurations whose ranks replay them from
    the reference's starting params."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models import build as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.utils.params import from_jax_params
    from test_torch_engine import RefDraws
    from test_torch_streamed import RefBlockDraws

    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**tr.MODEL))
    pm = build(get_config("gboard-cifg-lstm").with_(**tr.MODEL))
    p0 = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    params = from_jax_params(p0, pm.compute_copies, device="cpu")
    emax = tr.setup()[1].to_device_arrays()["examples"].shape[1]
    specs = []
    for sampler, cls in (("global", RefDraws), ("sharded", RefBlockDraws)):
        rec = tr.Recorder(cls(0, emax))
        spec = tr.run_spec(f"reference {sampler}", sampler=sampler,
                           rounds=K_REF, draws=rec, params=params)
        tr.runs(CPU, [spec])
        specs.append(dict(spec, draws=rec.replay()))
    return specs


@pytest.fixture(scope="module")
def ranks(reference):
    """``at(pods, shards)``: every rank's runs of the configurations (and,
    on 4 ranks, the replays of the reference's draws), one spawn a
    topology, memoized; ``at(1, 1)`` the one-rank runs in this process."""
    replays = _replay_specs()
    done = {(1, 1): tr.runs(CPU, SPECS)}

    def at(pods, shards):
        if (pods, shards) not in done:
            specs = SPECS + (replays if pods * shards == 4 else [])
            done[(pods, shards)] = spawn_ranks(
                tr.runs, pods * shards, (specs, shards, pods), device="cpu")
        return done[(pods, shards)]

    return at


@pytest.mark.parametrize("pods,shards", [(1, 2), (1, 4), (2, 2)])
def test_sharded_engine_is_bitwise_the_one_rank_engine(ranks, pods, shards):
    one, out = ranks(1, 1), ranks(pods, shards)
    bad = {(rank, name): diff for rank, res in enumerate(out)
           for name, run in one.items()
           if (diff := tr.same_run(res[name], run))}
    assert not bad, bad
    # the round sum crossed the ranks: every round gathered the block
    # partials (blocks x (params + 4 stats) floats over data, then the pod
    # partials over pod), besides the sharded sampler's candidates
    n_par = sum(l.numel() for l in tree_leaves(one["fixed z0"]["params"]))
    per_round = 4 * (n_par + 4) * (8 // pods + (pods if pods > 1 else 0))
    for res in out:
        assert res["fixed z0"]["gathered"] == 3 * per_round
        assert res["sharded fixed"]["gathered"] > 3 * per_round


def test_sharded_engine_matches_the_references_shard_map(ranks, reference):
    from test_torch_engine import _close_trees

    ports = {(p, s): ranks(p, s) for p, s in ((1, 4), (2, 2))}
    proc, npz = reference
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-3000:]
    want = np.load(npz)
    for (pods, shards), sampler in REFERENCE_RUNS:
        key, name = f"{pods}x{shards}/{sampler}", f"reference {sampler}"
        out = ports[(pods, shards)]
        for res in out[1:]:
            assert not tr.same_run(res[name], out[0][name])
        got = out[0][name]
        for k in ("participation", "last_round"):
            np.testing.assert_array_equal(got[k].numpy(), want[f"{key}/{k}"],
                                          err_msg=f"{key} {k}")
        np.testing.assert_array_equal(got["hist"]["n_clients"],
                                      want[f"{key}/hist/n_clients"])
        for k in ("loss", "mean_update_norm", "frac_clipped"):
            np.testing.assert_allclose(got["hist"][k],
                                       want[f"{key}/hist/{k}"], rtol=1e-4,
                                       atol=1e-6, err_msg=f"{key} {k}")
        for k in ("params", "momentum"):
            n = len(tree_leaves(got[k]))
            _close_trees(got[k], [want[f"{key}/{k}/{i}"] for i in range(n)])


if __name__ == "__main__":
    _reference_main(sys.argv[1])
