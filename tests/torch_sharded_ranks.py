"""What one rank runs in the sharded-engine tests (`test_torch_engine_
sharded.py`, `test_torch_sharding.py`). Imports nothing of JAX or of the
JAX package: the spawned ranks import this module (and `repro_torch`)
only.

A run is described by a picklable dict (:func:`run_spec`); :func:`runs`
builds the same small model, population and starting params on every rank,
runs each configuration through `SimEngine` and returns what the tests
compare bitwise: params, momentum, the whole population vectors and the
history. Called in the test process with ``num_shards = num_pods = 1`` it
is the one-rank run the ranks are held against.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.engine import SimEngine
from repro_torch.fl.faults import FaultConfig
from repro_torch.models import build
from repro_torch.utils import spans
from repro_torch.utils.pytree import tree_leaves

# the reference's pod tests' sizes (vocab 300, d 24, 80 users), cohort 16
MODEL = dict(vocab=300, d_model=24, d_ff=48, compute_dtype="float32",
             cell_path="seq")
DATA = dict(n_users=80, seq_len=16, sentences_per_user=20)
COHORT = 16
DP = dict(clients_per_round=COHORT, clip_norm=0.8, server_opt="momentum",
          server_lr=0.5, server_momentum=0.9)
CLIENT = dict(local_epochs=1, batch_size=10, lr=0.3)
ENGINE = dict(n_local_batches=2, rounds_per_call=2)
FAULTS = dict(seed=7, dropout_prob=0.1, straggler_prob=0.2,
              straggler_mean_delay=1.0, round_deadline=3.0,
              corrupt_prob=0.05)


def run_spec(name: str, sampling: str = "fixed", sigma: float = 0.0,
             sampler: str = "global", backend: str = "device",
             faults: bool = False, chunk=None, rounds: int = 3,
             draws=None, params=None) -> Dict:
    """One configuration: the engine's options and the rounds to run
    (``rounds_per_call`` 2, so 3 rounds are a call of 2 and a call of 1).
    ``draws`` is a :class:`ReplayDraws` or None (the engine's
    generator, seeded 0); ``params`` the starting params or None (the
    model's init from seed 1)."""
    return dict(name=name, sampling=sampling, sigma=sigma, sampler=sampler,
                backend=backend, faults=faults, chunk=chunk, rounds=rounds,
                draws=draws, params=params)


class ReplayDraws:
    """`fl.engine.EngineDraws`' methods returning recorded draws: each
    round's draws in the order one engine made them, and the block draws
    of every block by (stream, round), so a rank takes its own blocks'
    rows. Every rank replays the same list, as every rank of a sharded
    engine makes the same draws."""

    def __init__(self, calls: List, blocks: Dict):
        self.calls = list(calls)
        self.blocks = blocks
        self.at = 0

    def _next(self, name):
        got, value = self.calls[self.at]
        if got != name:
            raise AssertionError(f"replay expected {got}, the engine asked "
                                 f"for {name} (call {self.at})")
        self.at += 1
        return value

    def begin_round(self, round_idx):
        pass

    def available(self, n):
        return self._next("available")

    def cohort(self, weights, available, cohort):
        return self._next("cohort")

    def poisson(self, q, available, buffer):
        return self._next("poisson")

    def example_indices(self, counts, need):
        return self._next("example_indices")

    def noise(self, like, std):
        return self._next("noise")

    def block_uniforms(self, stream, round_idx, block_ids, blk):
        return self.blocks[(stream, round_idx)][list(block_ids)]

    def block_gumbels(self, round_idx, block_ids, blk):
        return self.blocks[("gumbel", round_idx)][list(block_ids)]


class Recorder:
    """Wraps a draws object and records what it returns, for
    :class:`ReplayDraws` (the block draws must be asked for every block,
    as one rank asks)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls, self.blocks = [], {}

    def replay(self) -> ReplayDraws:
        return ReplayDraws(self.calls, self.blocks)

    def begin_round(self, round_idx):
        self.inner.begin_round(round_idx)

    def _rec(self, name, value):
        self.calls.append((name, value))
        return value

    def available(self, n):
        return self._rec("available", self.inner.available(n))

    def cohort(self, weights, available, cohort):
        return self._rec("cohort", self.inner.cohort(weights, available,
                                                     cohort))

    def poisson(self, q, available, buffer):
        return self._rec("poisson", self.inner.poisson(q, available, buffer))

    def example_indices(self, counts, need):
        return self._rec("example_indices",
                         self.inner.example_indices(counts, need))

    def noise(self, like, std):
        return self._rec("noise", self.inner.noise(like, std))

    def block_uniforms(self, stream, round_idx, block_ids, blk):
        out = self.inner.block_uniforms(stream, round_idx, block_ids, blk)
        self.blocks[(stream, round_idx)] = out
        return out

    def block_gumbels(self, round_idx, block_ids, blk):
        out = self.inner.block_gumbels(round_idx, block_ids, blk)
        self.blocks[("gumbel", round_idx)] = out
        return out


def setup(cell_path: str = "seq"):
    """The model, the dataset and the starting params, the same on every
    rank."""
    model = build(get_config("gboard-cifg-lstm").with_(
        **dict(MODEL, cell_path=cell_path)))
    ds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), **DATA)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    return model, ds, params


def engine(model, ds, spec: Dict, num_shards: int = 1, num_pods: int = 1,
           device="cpu") -> SimEngine:
    dp = DPConfig(noise_multiplier=spec["sigma"], sampling=spec["sampling"],
                  **DP)
    data = ds if spec["backend"] == "streamed" else ds.to_device_arrays()
    return SimEngine(
        model, data, dp, ClientConfig(**CLIENT), **ENGINE,
        availability=availability(spec["sampling"]),
        num_shards=num_shards, num_pods=num_pods,
        cohort_chunk=spec["chunk"], population_backend=spec["backend"],
        sampler=spec["sampler"],
        fault_config=FaultConfig(**FAULTS) if spec["faults"] else None,
        device=device)


def availability(sampling: str) -> float:
    return 1.0 if sampling == "poisson" else 0.6


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def _launches() -> Dict[str, int]:
    from repro_torch.kernels.cifg_cell import ops as cell_ops
    from repro_torch.kernels.dp_clip import ops as clip_ops
    return {**cell_ops.LAUNCHES, **clip_ops.LAUNCHES}


def runs(device, specs: List[Dict], num_shards: int = 1, num_pods: int = 1,
         cell_path: str = "seq") -> Dict[str, Dict]:
    """Every configuration of ``specs`` on this rank (one rank when
    ``num_shards = num_pods = 1``): ``{name: {"params", "momentum",
    "participation", "last_round", "hist", "gathered", "launches"}}``, all
    on the host; the population vectors whole, ``gathered`` the bytes this
    rank's gathers received, ``launches`` its kernel launches (none on the
    CPU)."""
    torch.set_num_threads(1)
    model, ds, params = setup(cell_path)
    out = {}
    for spec in specs:
        before = _launches()
        e = engine(model, ds, spec, num_shards, num_pods, device)
        state = e.init_state(params if spec["params"] is None
                             else spec["params"], seed=0,
                             draws=spec["draws"])
        with spans.recording() as rec:
            state, hist = e.run(state, spec["rounds"])
        out[spec["name"]] = dict(
            params=_host(state.params),
            momentum=_host(state.opt_state.momentum),
            participation=e.population(state.participation).cpu(),
            last_round=e.population(state.last_round).cpu(),
            hist=hist, gathered=rec.counts["gather_bytes"],
            launches={k: v - before[k] for k, v in _launches().items()})
    return out


def same_run(a: Dict, b: Dict) -> List[str]:
    """What differs between two :func:`runs` results of one configuration
    (empty when they are bitwise equal)."""
    bad = []
    for k in ("params", "momentum"):
        if not all(torch.equal(x, y) for x, y in zip(tree_leaves(a[k]),
                                                     tree_leaves(b[k]))):
            bad.append(k)
    for k in ("participation", "last_round"):
        if not torch.equal(a[k], b[k]):
            bad.append(k)
    for k in a["hist"]:
        if not np.array_equal(a["hist"][k], b["hist"][k]):
            bad.append(f"hist[{k}]")
    return bad


def mesh_facts(device, pods: int, shards: int) -> Dict:
    """One rank's view of the cohort mesh and of a 2 x 2 production mesh
    over the same ranks: axis names, its coordinate, `shard_rank`, and
    `gather_shards` of a (2, 3) candidate array holding its rank."""
    from repro_torch.configs.base import MeshConfig
    from repro_torch.fl.pop_sampler import gather_shards, shard_rank
    from repro_torch.launch.mesh import make_cohort_mesh, make_production_mesh
    from repro_torch.sharding.specs import sim_mesh_config

    mesh = make_cohort_mesh(sim_mesh_config(shards, pods), device.type)
    rank = shard_rank(mesh)
    x = torch.full((2, 3), float(rank)) + torch.arange(2.0)[:, None] / 10
    prod = make_production_mesh(shape=(2, 2), device_type=device.type)
    refused = []
    for cfg in (MeshConfig((pods * shards, 1), ("data", "model")),
                sim_mesh_config(2 * shards, pods)):
        try:
            make_cohort_mesh(cfg, device.type)
        except ValueError as e:
            refused.append(str(e))
    return dict(names=mesh.mesh_dim_names, coord=mesh.get_coordinate(),
                rank=rank, gathered=gather_shards(x.to(device), mesh).cpu(),
                production=prod.mesh_dim_names, refused=refused)
