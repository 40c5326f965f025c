"""Federated round orchestration: sample → local train → Algorithm 1's
server step (the reference's ``fl/round.py``, host backend).

``FederatedTrainer(backend="host")`` draws everything with numpy, in the
reference's order: the check-in pool and the cohort (`fl.sampling.
sample_round`), then each sampled user's client tensor (`data.federated.
FederatedDataset.user_tensor`). With the same seed the port and the
reference therefore train on the same cohorts and the same batches. The
round body is `fl.client.round_compute` on the device; the Gaussian noise
comes from a ``torch.Generator`` on the device, or from ``noise_fn`` when a
caller injects it (the port cannot draw JAX's bits).

The reference's compiled engine backends (``"engine"``, ``"engine_python"``)
are not ported yet (ROADMAP.md, queue A, item 4): asking for one raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ClientConfig, DPConfig
from repro_torch.core import accountant as acct
from repro_torch.core.dp_fedavg import finalize_round, server_step
from repro_torch.core.server_optim import ServerOptState, init_state
from repro_torch.data.federated import FederatedDataset
from repro_torch.fl.client import make_round_fn
from repro_torch.fl.population import PopulationSim
from repro_torch.fl.sampling import sample_round
from repro_torch.models.api import Model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import tree_map

BACKENDS = ("host",)


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
    ``seed + 1``. ``noise_fn(round_idx, like, std) -> tree`` (optional)
    replaces the generator's draw of each round's noise (a tree shaped like
    ``like``, already scaled by ``std``)."""

    def __init__(self, model: Model, dataset: FederatedDataset,
                 dp: DPConfig, client: ClientConfig,
                 pop: Optional[PopulationSim] = None, seed: int = 0,
                 n_local_batches: int = 4, backend: str = "host",
                 sampling: Optional[str] = None,
                 cohort_chunk: Optional[int] = None,
                 clip_path: str = "fused", params=None, device=None,
                 noise_fn: Optional[Callable] = None):
        if backend not in BACKENDS:
            raise NotImplementedError(
                f"backend {backend!r} is not ported yet: the port trains "
                f"with backend='host'; the engine backends are queued in "
                f"ROADMAP.md (queue A, item 4)")
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
        n_users = len(dataset.users)
        synth = [u.user_id for u in dataset.users if u.is_synthetic]
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
        self._round_fn = make_round_fn(model, client, dp,
                                       cohort_chunk=cohort_chunk,
                                       clip_path=clip_path)

    def _stack_clients(self, ids: np.ndarray) -> Dict[str, torch.Tensor]:
        tensors = [self.dataset.user_tensor(int(u), self.client.batch_size,
                                            self.n_local_batches, self.rng)
                   for u in ids]
        return {k: torch.from_numpy(np.stack([t[k] for t in tensors]))
                .to(self.device) for k in tensors[0]}

    def run_round(self) -> Dict:
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

    def train(self, rounds: int, log_every: int = 0) -> List[Dict]:
        for r in range(rounds):
            rec = self.run_round()
            if log_every and (r + 1) % log_every == 0:
                self._log(rec)
        return self.state.history

    @staticmethod
    def _log(rec: Dict) -> None:
        print(f"round {rec['round']:4d}  loss {rec['loss']:.4f}  "
              f"clipped {rec['frac_clipped']:.2f}  "
              f"norm {rec['mean_update_norm']:.3f}")
