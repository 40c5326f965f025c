"""Federated round orchestration: sample → local train → Algorithm 1's
server step (the reference's ``fl/round.py``). Three backends:

* ``"engine"`` — the simulation engine (`repro_torch.fl.engine.SimEngine`):
  population, sampling, client batching and the server step all on the
  device, ``rounds_per_call`` rounds between host reads;
* ``"engine_python"`` — the engine read after every round (the same draws
  → bitwise the same trajectory; used by parity tests);
* ``"host"`` — numpy sampling and host stacking, in the reference's order:
  the check-in pool and the cohort (`fl.sampling.sample_round`), then each
  sampled user's client tensor (`data.federated.FederatedDataset.
  user_tensor`). With the same seed the port and the reference therefore
  train on the same cohorts and the same batches.

Every backend runs the round body of `fl.client` on the device. The engine
draws everything from one ``torch.Generator`` on the device, seeded from
``seed`` (or from ``draws``, an object with `fl.engine.EngineDraws`'
methods); the host backend's Gaussian noise comes from a ``torch.Generator``
on the device, or from ``noise_fn`` when a caller injects it (the port
cannot draw JAX's bits).

Engine backends take an ``eval_fn(params, round_idx)`` hook, run every
``eval_every`` rounds, whose outputs land in ``trainer.eval_history``.

Engine backends also take ``fault_config`` (`fl.faults.FaultConfig`): the
production round protocol — over-selection, report goals, aborts that
change nothing. The accountant then composes only *committed* rounds (an
aborted round released nothing), and round records carry ``n_selected``,
``n_reported``, ``n_clients`` (the accepted reports) and ``committed``.
:meth:`FederatedTrainer.save_run_state` and :meth:`restore_run_state` make
a long run survive a crash: the resumed run is bitwise the uninterrupted
one, faults on or off.

Engine backends take the reference's ``population_backend`` (``"device"``
or ``"streamed"``: the corpus on the host, one cohort staged a round),
``population_store`` (a `data.population_store.PopulationStore`, which may
replace the dataset: ``dataset=None``) and ``sampler`` (``"global"`` or the
block-keyed ``"sharded"``). The host backend refuses them, as the
reference's does.

Engine backends take ``num_shards`` / ``num_pods``: the cohort sharded over
that many ranks, one process each (`repro_torch.launch.mesh`), every rank
building the same trainer. The trajectory is bitwise the one-rank one.
The population vectors the trainer mirrors and snapshots are whole on
every rank (`fl.engine.SimEngine.population`), and only rank 0 writes a
snapshot, so a snapshot does not depend on the topology and restores on
any.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ClientConfig, DPConfig
from repro_torch.core import accountant as acct
from repro_torch.core.dp_fedavg import finalize_round, server_step
from repro_torch.core.server_optim import ServerOptState, init_state
from repro_torch.data.federated import FederatedDataset
from repro_torch.data.population_store import as_population_store
from repro_torch.fl.client import make_round_fn
from repro_torch.fl.engine import EngineDraws, EngineState, SimEngine
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.sampling import sample_round
from repro_torch.models.api import Model
from repro_torch.train import checkpoint
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import tree_map

BACKENDS = ("host", "engine", "engine_python")


@dataclass
class TrainerState:
    params: object
    opt_state: ServerOptState
    round_idx: int = 0
    history: List[Dict] = field(default_factory=list)


class FederatedTrainer:
    """End-to-end DP-FedAvg trainer over a simulated device population.

    ``params`` (optional) starts training from a given parameter set (for
    example the reference's, carried across by `utils.params.
    from_jax_params`); by default the model is initialised from
    ``seed + 1``. ``noise_fn(round_idx, like, std) -> tree`` (optional, host
    backend) replaces the generator's draw of each round's noise (a tree
    shaped like ``like``, already scaled by ``std``); ``draws`` (optional,
    engine backends) replaces the engine's generator
    (`fl.engine.EngineDraws`). ``population_store`` (engine backends) is
    the population's corpus; with it ``dataset`` may be None."""

    def __init__(self, model: Model, dataset: Optional[FederatedDataset],
                 dp: DPConfig, client: ClientConfig,
                 pop: Optional[PopulationSim] = None, seed: int = 0,
                 n_local_batches: int = 4, backend: str = "host",
                 rounds_per_call: int = 8, sampling: Optional[str] = None,
                 num_shards: int = 1, num_pods: int = 1,
                 cohort_chunk: Optional[int] = None,
                 clip_path: str = "fused",
                 population_backend: str = "device",
                 population_store=None, sampler: str = "global",
                 fault_config=None, eval_fn: Optional[Callable] = None,
                 eval_every: int = 1, params=None, device=None,
                 noise_fn: Optional[Callable] = None, draws=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if (num_shards != 1 or num_pods != 1) and backend == "host":
            raise ValueError("num_shards/num_pods are engine-backend "
                             "features (the host loop stacks clients on one "
                             "host); use backend='engine'")
        if backend == "host" and (
                sampler != "global"
                or population_backend != "device"
                or population_store is not None
                or fault_config is not None):
            raise ValueError("sampler, "
                             "population_backend/population_store and "
                             "fault_config are engine-backend features; use "
                             "backend='engine'")
        if dataset is None and population_store is None:
            raise ValueError("pass a FederatedDataset, a population_store, "
                             "or both")
        if backend == "host" and eval_fn is not None:
            raise ValueError("eval_fn is an engine-backend feature "
                             "(in-engine hook); score params post hoc on "
                             "the host backend instead")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the reference's float32 products are full float32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.model = model
        self.dataset = dataset
        self.dp = dp
        self.client = client
        self.n_local_batches = n_local_batches
        self.backend = backend
        self.sampling = sampling or dp.sampling
        if self.sampling not in ("fixed", "poisson"):
            raise ValueError(f"sampling must be 'fixed' or 'poisson', "
                             f"got {self.sampling!r}")
        self.population_store = None
        if population_store is not None:
            store = as_population_store(population_store)
            if dataset is not None and len(dataset.users) != store.n_users:
                raise ValueError(
                    f"dataset has {len(dataset.users)} users but the "
                    f"population store holds {store.n_users} — pass matching "
                    "populations (or only one of the two)")
            self.population_store = store
            n_users = store.n_users
            synth = np.nonzero(np.asarray(store.synthetic))[0].tolist()
        else:
            n_users = len(dataset.users)
            synth = [u.user_id for u in dataset.users if u.is_synthetic]
        self.n_users = n_users
        self.pop = pop or PopulationSim(n_users, synthetic_ids=synth,
                                        seed=seed)
        self.rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.noise_fn = noise_fn
        self.accountant = acct.MomentsAccountant(
            q=dp.clients_per_round / max(n_users, 1),
            noise_multiplier=dp.noise_multiplier,
            sampling="poisson" if self.sampling == "poisson" else "wor")
        if params is None:
            params = model.init(torch.Generator().manual_seed(seed + 1),
                                device=self.device)
        params = tree_map(lambda l: l.detach().to(self.device),
                          strip_compute(params))
        self.state = TrainerState(params, init_state(params))
        self.participation = np.zeros(n_users, np.int64)
        # engine hook output, accumulated across calls: {"round": (n,),
        # "mask": (n,) bool, "values": {name: (n, ...)}}
        self.eval_history: Optional[Dict] = None
        self.engine = None
        if backend == "host":
            self._round_fn = make_round_fn(model, client, dp,
                                           cohort_chunk=cohort_chunk,
                                           clip_path=clip_path)
            return
        # scalar population dynamics come from the PopulationSim config;
        # the synthetic-device mask comes from the dataset itself (the
        # engine's draws are seeded with the trainer seed, not pop.seed)
        if sorted(self.pop.synthetic_ids) != synth:
            raise ValueError(
                "engine backends take the synthetic-device mask from the "
                f"dataset ({synth}), but the PopulationSim was built with "
                f"synthetic_ids={list(self.pop.synthetic_ids)} — make them "
                "agree (or omit synthetic_ids)")
        data = (self.population_store if self.population_store is not None
                else dataset.to_device_arrays())
        self.engine = SimEngine(
            model, data, dp, client,
            n_local_batches=n_local_batches,
            availability=self.pop.availability,
            pace_cooldown=self.pop.pace_cooldown,
            pace_penalty=self.pop.pace_penalty,
            rounds_per_call=rounds_per_call, sampling=self.sampling,
            num_shards=num_shards, num_pods=num_pods,
            cohort_chunk=cohort_chunk, clip_path=clip_path,
            population_backend=population_backend, sampler=sampler,
            fault_config=fault_config, eval_fn=eval_fn,
            eval_every=eval_every, device=self.device)
        self._estate = self.engine.init_state(
            params, seed=seed, opt_state=self.state.opt_state, draws=draws)

    def _stack_clients(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        tensors = [self.dataset.user_tensor(int(u), self.client.batch_size,
                                            self.n_local_batches, self.rng)
                   for u in ids]
        return {k: torch.from_numpy(np.stack([t[k] for t in tensors]))
                .to(self.device) for k in tensors[0]}

    def _run_round_host(self) -> Dict:
        s = self.state
        ids = sample_round(self.pop, self.rng, s.round_idx,
                           self.dp.clients_per_round, scheme=self.sampling)
        self.participation[ids] += 1
        if len(ids):
            total, mean_norm, frac_clipped, loss = self._round_fn(
                s.params, self._stack_clients(ids))
        else:  # an empty Poisson round still takes a (pure-noise) step
            total = tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32),
                             s.params)
            mean_norm = frac_clipped = loss = torch.zeros(
                (), device=self.device)
        # Poisson rounds divide by the expected round size qN, fixed rounds
        # by the realized (= configured) size, as in Algorithm 1
        denom = (len(ids) if self.sampling == "fixed"
                 else self.dp.clients_per_round)
        noise = None
        if self.noise_fn is not None:
            std = self.dp.noise_multiplier * self.dp.clip_norm / float(denom)
            noise = self.noise_fn(s.round_idx, total, std)
        delta, stats = finalize_round(total, denom, self.generator, self.dp,
                                      stats=(mean_norm, frac_clipped),
                                      noise=noise)
        s.params, s.opt_state = server_step(s.params, s.opt_state, delta,
                                            self.dp)
        self.accountant.step()
        s.round_idx += 1
        rec = {"round": s.round_idx, "loss": float(loss),
               "mean_update_norm": float(mean_norm),
               "frac_clipped": float(frac_clipped),
               "n_clients": int(len(ids)),
               "n_target": int(self.dp.clients_per_round),
               "noise_std": float(stats.noise_std)}
        s.history.append(rec)
        return rec

    # ----------------------------------------------------------- engine path

    def _append_eval(self, rounds_arr: np.ndarray, mask: np.ndarray,
                     values: Dict) -> None:
        chunk = {"round": rounds_arr, "mask": np.asarray(mask, bool),
                 "values": values}
        if self.eval_history is None:
            self.eval_history = chunk
        else:
            old = self.eval_history
            self.eval_history = {
                "round": np.concatenate([old["round"], chunk["round"]]),
                "mask": np.concatenate([old["mask"], chunk["mask"]]),
                "values": {k: np.concatenate([old["values"][k], v])
                           for k, v in values.items()}}

    def _train_engine(self, rounds: int, log_every: int = 0) -> List[Dict]:
        s = self.state
        runner = (self.engine.run if self.backend == "engine"
                  else self.engine.run_python)
        recs = []
        done = 0
        stepped = 0
        while done < rounds:
            # chunk by log_every so progress lines appear while training
            k = min(log_every or rounds, rounds - done)
            start = s.round_idx
            self._estate, hist = runner(self._estate, k)
            if "eval" in hist:
                self._append_eval(np.arange(start + 1, start + k + 1),
                                  hist["eval_mask"], hist["eval"])
            faulted = "committed" in hist
            # only committed rounds released anything, so only they compose
            stepped += int(np.sum(hist["committed"])) if faulted else k
            for i in range(k):
                s.round_idx += 1
                rec = {"round": s.round_idx, "loss": float(hist["loss"][i]),
                       "mean_update_norm":
                           float(hist["mean_update_norm"][i]),
                       "frac_clipped": float(hist["frac_clipped"][i]),
                       "n_clients": int(hist["n_clients"][i]),
                       "noise_std": float(hist["noise_std"][i])}
                if faulted:
                    rec["n_selected"] = int(hist["n_selected"][i])
                    rec["n_reported"] = int(hist["n_reported"][i])
                    rec["committed"] = bool(hist["committed"][i])
                s.history.append(rec)
                recs.append(rec)
                if log_every and rec["round"] % log_every == 0:
                    self._log(rec)
            done += k
        s.params = self._estate.params
        s.opt_state = self._estate.opt_state
        self.accountant.step(stepped)
        self._mirror_population()
        return recs

    def _mirror_population(self) -> None:
        """Mirror the device population state back into the host
        PopulationSim so post-hoc analyses see it (the sharded sampler's
        vectors carry padding rows past ``n_users``, which never
        participate)."""
        n, whole = self.n_users, self.engine.population
        self.participation = whole(self._estate.participation)[:n].cpu(
        ).numpy().astype(np.int64)
        self.pop.absorb_last_round(
            whole(self._estate.last_round)[:n].cpu().numpy())

    # ------------------------------------------------------- crash resilience

    def _check_run_state(self) -> None:
        if self.engine is None:
            raise ValueError("save_run_state/restore_run_state are "
                             "engine-backend features; use backend='engine'")
        if type(self._estate.draws) is not EngineDraws:
            raise ValueError(
                "save_run_state/restore_run_state need the engine's own "
                "EngineDraws: an injected draws object has no generator "
                "state to save")

    def save_run_state(self, path) -> None:
        """Persist the whole mid-run state (engine backends): params,
        server-optimizer state, the engine generator's state, the population
        vectors, the round index, the accountant's position and the round
        history. The fault stream needs no state of its own: its position
        is the round index (`fl.faults`). Written atomically through
        `train.checkpoint.save` (temp file, then rename), so a crash during
        a save never destroys the previous state. Over several ranks every
        rank calls it (the population vectors are gathered whole) and rank
        0 alone writes."""
        self._check_run_state()
        est = self._estate
        last_round = self.engine.population(est.last_round)
        participation = self.engine.population(est.participation)
        if self.engine.rank != 0:
            return
        tree = {"estate": {
            "params": est.params,
            "opt_state": (est.opt_state.momentum, est.opt_state.nu,
                          np.asarray(torch.as_tensor(est.opt_state.count)
                                     .cpu())),
            "generator": est.draws.generator.get_state(),
            "last_round": last_round,
            "participation": participation,
            "round_idx": np.asarray(est.round_idx, np.int32)}}
        checkpoint.save(Path(path), tree, meta={
            "kind": "trainer-run-state", "version": "1",
            "round_idx": str(self.state.round_idx),
            "accountant_rounds": str(self.accountant.rounds),
            "history": json.dumps(self.state.history)})

    def restore_run_state(self, path) -> int:
        """Restore a :meth:`save_run_state` snapshot and return the round
        index to resume from. Running the remaining rounds then gives the
        uninterrupted trajectory bitwise (the generator's state, the
        population vectors and the fault stream's position — the round
        index — are all in the snapshot)."""
        self._check_run_state()
        tree, meta = checkpoint.load(Path(path))
        if meta.get("kind") != "trainer-run-state":
            raise checkpoint.CheckpointError(
                f"{path} is not a trainer run-state snapshot "
                f"(kind={meta.get('kind')!r})")
        est, dev = tree["estate"], self.device
        on_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        momentum, nu, count = est["opt_state"]
        # a count the fault model selected lives on the device; otherwise
        # it is the plain int it was saved from
        count = (on_dev(count) if self.engine.faults is not None
                 else int(count))
        draws = self._estate.draws
        draws.generator.set_state(torch.from_numpy(est["generator"]))
        self._estate = EngineState(
            params=tree_map(on_dev, est["params"]),
            opt_state=ServerOptState(tree_map(on_dev, momentum),
                                     tree_map(on_dev, nu), count),
            draws=draws,
            last_round=self.engine.local_rows(on_dev(est["last_round"])),
            participation=self.engine.local_rows(
                on_dev(est["participation"])),
            round_idx=int(est["round_idx"]))
        self.state.params = self._estate.params
        self.state.opt_state = self._estate.opt_state
        self.state.round_idx = int(meta["round_idx"])
        self.state.history = json.loads(meta["history"])
        self.accountant.restore_rounds(int(meta["accountant_rounds"]))
        self._mirror_population()
        return self.state.round_idx

    # ---------------------------------------------------------------- public

    def run_round(self) -> Dict:
        if self.backend != "host":
            return self._train_engine(1)[-1]
        return self._run_round_host()

    def train(self, rounds: int, log_every: int = 0) -> List[Dict]:
        if self.backend != "host":
            self._train_engine(rounds, log_every)
            return self.state.history
        for r in range(rounds):
            rec = self._run_round_host()
            if log_every and (r + 1) % log_every == 0:
                self._log(rec)
        return self.state.history

    @staticmethod
    def _log(rec: Dict) -> None:
        print(f"round {rec['round']:4d}  loss {rec['loss']:.4f}  "
              f"clipped {rec['frac_clipped']:.2f}  "
              f"norm {rec['mean_update_norm']:.3f}")
