"""The port's sharding layer: `configs.base.MeshConfig`,
`sharding.specs`, `launch.mesh`, `fl.reduction.fold_pods` /
`cohort_sum`, `fl.pop_sampler.shard_rank` / `gather_shards`, the kernel
build's lock, and the training CLI under ``torchrun``.

Against the reference: `MeshConfig`, `SINGLE_POD` / `MULTI_POD`,
`sim_mesh_config`, `batch_axes` and `batch_axis_size` equal;
`fold_pods` bitwise on seeded numpy blocks for 1, 2, 4 and 8 pods (each
step is one IEEE add in a fixed tree); `cohort_sum` within 1e-6 relative
(XLA and torch order a block's inner sum differently), and bitwise across
``num_pods`` within the port; `make_cohort_mesh`'s two refusals.

On ranks (gloo, the CPU, `launch.mesh.spawn_ranks`): the cohort mesh's
pod-major layout, `shard_rank`, `gather_shards`' pod-major order, and the
training CLI on 2 ranks under ``torchrun --standalone``, whose checkpoint
and history JSON are sha256-equal to the one-rank CLI's, uninterrupted and
crashed then resumed.
"""
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_ranks as tr
from repro.configs import base as jbase
from repro.fl import reduction as jred
from repro.sharding import specs as jspecs
from repro_torch.configs import base
from repro_torch.fl import reduction
from repro_torch.launch import mesh
from repro_torch.sharding import specs
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------ configs and specs


@pytest.mark.parametrize("shards,pods", [(1, 1), (4, 1), (2, 2), (8, 1),
                                         (4, 2), (3, 1)])
def test_mesh_configs_and_specs_are_the_references(shards, pods):
    for name in ("SINGLE_POD", "MULTI_POD"):
        a, b = getattr(base, name), getattr(jbase, name)
        assert (a.shape, a.axes, a.n_devices) == (b.shape, b.axes,
                                                 b.n_devices)
    assert mesh.mesh_config() is base.SINGLE_POD
    assert mesh.mesh_config(multi_pod=True) is base.MULTI_POD
    ours, theirs = (specs.sim_mesh_config(shards, pods),
                    jspecs.sim_mesh_config(shards, pods))
    assert (ours.shape, ours.axes) == (theirs.shape, theirs.axes)
    assert tuple(ours.axes) in mesh.COHORT_AXES
    for cfg, jcfg in ((ours, theirs), (base.SINGLE_POD, jbase.SINGLE_POD),
                      (base.MULTI_POD, jbase.MULTI_POD)):
        assert specs.batch_axes(cfg) == jspecs.batch_axes(jcfg)
        assert specs.batch_axis_size(cfg) == jspecs.batch_axis_size(jcfg)
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            specs.sim_mesh_config(*bad)
        with pytest.raises(ValueError):
            jspecs.sim_mesh_config(*bad)


def test_owned_rows_tile_the_axis_pod_major():
    for total in (1, 2, 4, 8):
        rows = [specs.owned_rows(64, r, total) for r in range(total)]
        assert rows[0][0] == 0 and rows[-1][1] == 64
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    with pytest.raises(ValueError, match="pad it"):
        specs.owned_rows(10, 0, 4)


def test_make_cohort_mesh_refuses_what_the_reference_refuses():
    from repro.launch import mesh as jmesh

    model_axis = base.MeshConfig((2, 2), ("data", "model"))
    with pytest.raises(ValueError) as ours:
        mesh.make_cohort_mesh(model_axis, "cpu")
    with pytest.raises(ValueError) as theirs:
        jmesh.make_cohort_mesh(jbase.MeshConfig((2, 2), ("data", "model")))
    assert str(ours.value).split(" got ")[0] == \
        str(theirs.value).split(" got ")[0]
    # too few ranks: the launch command where the reference names XLA_FLAGS
    with pytest.raises(ValueError, match="needs 4 ranks but only 1") as e:
        mesh.make_cohort_mesh(specs.sim_mesh_config(2, 2), "cpu")
    assert "torch.distributed.run" in str(e.value)
    assert "--nproc-per-node 4" in str(e.value)
    with pytest.raises(ValueError, match="one entry per"):
        mesh.make_production_mesh(multi_pod=True, shape=(2, 2))


def test_init_distributed_takes_the_backend_it_is_given(monkeypatch):
    with pytest.raises(ValueError, match="backend must be"):
        mesh.init_distributed("mpi", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        mesh.init_distributed("gloo", "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    # NCCL is never swapped for gloo: on the CPU it is refused
    with pytest.raises(ValueError, match="nccl needs CUDA"):
        mesh.init_distributed("nccl", "cpu")


# ------------------------------------------------------- the fold


@pytest.mark.parametrize("pods", [1, 2, 4, 8])
def test_fold_pods_is_the_references_bitwise(pods):
    # blocks of very different scales, so that another association of the
    # tree would show in the low bits
    rng = np.random.default_rng(pods)
    blocks = (rng.standard_normal((8, 5, 7))
              * 10.0 ** rng.integers(-6, 7, (8, 1, 1))).astype(np.float32)
    ours = reduction.fold_pods(torch.from_numpy(blocks), pods).numpy()
    theirs = np.asarray(jred.fold_pods(jnp.asarray(blocks), pods))
    assert ours.tobytes() == theirs.tobytes()
    # a pod partial is an inner node of the flat tree
    assert torch.equal(torch.from_numpy(ours),
                       reduction.fold_blocks(torch.from_numpy(blocks)))
    if pods > 1:
        nine = np.concatenate([blocks, blocks[:1]])
        with pytest.raises(ValueError, match="must divide") as e:
            reduction.fold_pods(torch.from_numpy(nine), pods)
        with pytest.raises(ValueError) as je:
            jred.fold_pods(jnp.asarray(nine), pods)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("n_slots", [10, 16, 37])
def test_cohort_sum_matches_the_reference_and_ignores_the_pod_count(n_slots):
    rng = np.random.default_rng(n_slots)
    tree = {"a": rng.standard_normal((n_slots, 6, 3)).astype(np.float32),
            "b": rng.standard_normal((n_slots,)).astype(np.float32)}
    mask = (rng.random(n_slots) < 0.7).astype(np.float32)
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    ours = {p: reduction.cohort_sum(ttree, torch.from_numpy(mask),
                                    num_pods=p) for p in (1, 2, 4, 8)}
    for p in (2, 4, 8):
        assert all(torch.equal(ours[p][k], ours[1][k]) for k in tree)
    theirs = jred.cohort_sum({k: jnp.asarray(v) for k, v in tree.items()},
                             jnp.asarray(mask), num_pods=2)
    for k in tree:
        np.testing.assert_allclose(ours[2][k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6, atol=1e-6 * float(
                                       np.abs(tree[k]).sum()))
    # masked slots add exactly nothing, whatever they hold
    poisoned = {k: torch.where(torch.from_numpy(mask > 0).reshape(
        (-1,) + (1,) * (v.dim() - 1)), v, 1e30) for k, v in ttree.items()}
    again = reduction.cohort_sum(poisoned, torch.from_numpy(mask))
    assert all(torch.equal(again[k], ours[1][k]) for k in tree)


# --------------------------------------------------------- on ranks


@pytest.mark.parametrize("pods,shards", [(1, 4), (2, 2)])
def test_cohort_mesh_lays_ranks_out_pod_major(pods, shards):
    facts = mesh.spawn_ranks(tr.mesh_facts, 4, (pods, shards), device="cpu")
    want = torch.cat([torch.full((2, 3), float(r))
                      + torch.arange(2.0)[:, None] / 10 for r in range(4)])
    names = ("data",) if pods == 1 else ("pod", "data")
    for r, f in enumerate(facts):
        assert f["names"] == names and f["rank"] == r
        assert list(f["coord"]) == ([r] if pods == 1
                                    else [r // shards, r % shards])
        assert torch.equal(f["gathered"], want)
        assert f["production"] == ("data", "model")
        assert "Model-parallel axes" in f["refused"][0]
        assert "--nproc-per-node 8" in f["refused"][1]


def test_a_failing_rank_stops_the_others_and_raises():
    with pytest.raises(RuntimeError, match="needs 8 ranks but only 2"):
        mesh.spawn_ranks(tr.mesh_facts, 2, (1, 8), device="cpu",
                         timeout=120)


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Two builders at once (threads here; ranks or test workers in use):
    the lock makes the second find the first's library, so nvcc runs
    once, and the library appears whole under its final name."""
    from repro_torch.kernels import build

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = bin_dir / "nvcc"
    # a stand-in compiler: logs the call, takes a while, writes its -o
    nvcc.write_text("#!/bin/sh\necho x >> " + str(calls) + "\nsleep 0.5\n"
                    "while [ $# -gt 0 ]; do if [ \"$1\" = -o ]; then "
                    "echo lib > \"$2\"; fi; shift; done\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    errors = []

    def one():
        try:
            build.build(["dp_clip"])
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    assert calls.read_text().count("x") == 1
    lib = build.library_path("dp_clip")
    assert lib.read_text() == "lib\n"
    assert [p.name for p in lib.parent.iterdir()
            if p.name.endswith(".tmp")] == []
# ------------------------------------------------------------ the CLI


def _cli(tmp, out: str, nproc: int, *flags):
    """The training CLI on ``nproc`` ranks under torchrun (1: no
    torchrun), on the CPU."""
    args = ["-m", "repro_torch.launch.train", "--device", "cpu", "--vocab",
            "300", "--rounds", "3", "--n-users", "40",
            "--clients-per-round", "8", "--availability", "1.0",
            "--rounds-per-call", "2", "--out", str(tmp / out), *flags]
    if nproc > 1:
        args = ["-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", str(nproc)] + args + [
                    "--num-shards", str(nproc), "--dist-backend", "gloo"]
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.Popen([sys.executable, *args], env=env,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_cli_under_torchrun_is_bytewise_the_one_rank_cli(tmp_path):
    flags = ("--sampler", "sharded", "--fault-dropout", "0.1",
             "--checkpoint-every", "1")
    runs = {"one": _cli(tmp_path, "one", 1, *flags),
            "two": _cli(tmp_path, "two", 2, *flags),
            "cut": _cli(tmp_path, "cut", 2, *flags, "--crash-after", "2")}
    logs = {k: p.communicate(timeout=600)[0] for k, p in runs.items()}
    for k, p in runs.items():
        assert p.returncode == 0, f"{k}:\n{logs[k][-3000:]}"
    assert "simulated crash after round 2" in logs["cut"]
    resume = _cli(tmp_path, "cut", 2, *flags, "--resume")
    log = resume.communicate(timeout=600)[0]
    assert resume.returncode == 0 and "resumed from" in log, log[-3000:]
    # rank 0 alone prints and writes
    assert logs["two"].count("checkpoint: ") == 1
    for name in ("gboard-cifg-lstm_r3.msgpack",
                 "gboard-cifg-lstm_r3_history.json"):
        want = _sha(tmp_path / "one" / name)
        assert _sha(tmp_path / "two" / name) == want, name
        assert _sha(tmp_path / "cut" / name) == want, name


def test_cli_refuses_a_world_size_that_disagrees(tmp_path, capsys,
                                                 monkeypatch):
    from repro_torch.launch import train

    base = ["--device", "cpu", "--vocab", "300", "--rounds", "1",
            "--out", str(tmp_path)]
    with pytest.raises(SystemExit):
        train.main(base + ["--num-shards", "2"])
    assert "torch.distributed.run" in capsys.readouterr().err
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit):
        train.main(base + ["--num-pods", "2", "--num-shards", "1"])
    err = capsys.readouterr().err
    assert "= 2 rank(s), but 4 running" in err and "--nproc-per-node 2" in err
    with pytest.raises(SystemExit):
        train.main(base + ["--num-shards", "4", "--backend", "host"])
    assert "engine backend" in capsys.readouterr().err


