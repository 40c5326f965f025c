"""Multi-round DP-FedAvg simulation engine (the reference's
``fl/engine.py``: both population backends, both samplers, and the cohort
sharded over ``num_pods × num_shards`` ranks).

The host trainer (`repro_torch.fl.round.FederatedTrainer`,
``backend="host"``) samples cohorts and stacks client tensors with numpy
every round. This engine keeps the simulation on the device:

* **population** — per-round availability draws and Pace Steering weights
  computed on the device from a ``last_round`` vector (the weight function
  is a hook, see :func:`pace_steering_weights`);
* **sampling** — ``sampler="global"``: fixed-size weighted sampling without
  replacement (:func:`sample_cohort`, ``torch.multinomial``; unavailable
  devices carry weight 1e-30, so they are chosen only when fewer than
  ``cohort`` devices checked in), or Poisson rounds (:func:`poisson_select`):
  every available device i.i.d. Bernoulli(q = qN/N), the first ``buffer``
  of them packed into a fixed-shape cohort buffer with a slot mask.
  ``sampler="sharded"``: the block-keyed sampler of `fl.pop_sampler` — the
  population in canonical blocks, each block's uniforms from a generator of
  its own (:meth:`EngineDraws.block_uniforms`), the cohort an exact Gumbel
  top-k over unique (score, user id) keys, Poisson rounds packed in index
  order, and O(cohort) scatters into population vectors padded to whole
  blocks. The two samplers are two families of draws: each is
  deterministic in the seed, neither reproduces the other's cohorts;
* **data** — ``population_backend="device"``: client batches gathered from
  the padded corpus tensor of ``FederatedDataset.to_device_arrays()`` by
  per-slot example indices drawn uniformly in ``[0, counts[u])``
  (:func:`gather_client_batches`). ``population_backend="streamed"``: the
  corpus stays on the host behind a `data.population_store.PopulationStore`
  and each round's cohort rows are staged through two pinned host buffers
  into two device buffers of (padded, E_max, seq_len+1) int32, slot ``i``
  holding user ``ids[i]``'s rows, so the gathered tokens are bitwise the
  device backend's. The card holds the O(N) population vectors (``counts``
  for the index draw, ``last_round``, ``participation``, ``synthetic``:
  13 bytes a user, 15 with the sharded sampler's padded masks) and two
  staged cohorts, whatever N;
* **round** — the port's streaming round body
  (`repro_torch.fl.client.stream_block_sums`): the padded cohort in the
  canonical blocks, ``cohort_chunk`` clients at a time, each client's clip
  folded in slot order, so the sum is bitwise the same for every
  ``cohort_chunk`` dividing the block size; then noise and the server step.
  Δ̄ and σ = zS/qN use the fixed denominator qN, never the realized count;
* **eval hook** — ``eval_fn(params, round_idx) -> dict of tensors`` runs on
  the post-update params after rounds ``eval_every, 2·eval_every, …``;
  other rounds carry zeros (history keys ``eval`` / ``eval_mask``). It
  draws nothing, so whether it runs does not change the trajectory;
* **fault model** — with ``fault_config`` (`repro_torch.fl.faults`) a
  round over-selects ``ceil(qN / expected_survival)`` clients, folds only
  the slots that reported on time (corrupt reports are poisoned with NaN
  and rejected by the sum's non-finite guard), and commits only when the
  accepted count reaches the report goal: the server step is computed and
  every leaf of params and optimizer state is selected by a device-side
  ``committed``, so an aborted round leaves both bitwise unchanged without
  a host read. Δ̄ and σ = zS/report_goal divide by the goal, never by the
  realized count. The fates come from a per-round CPU stream
  (:meth:`EngineDraws.fates`), disjoint from the training generator.

Every draw of a round — availability, cohort or Poisson selection, per-slot
example indices, noise — comes from one ``torch.Generator`` on the engine's
device, through :class:`EngineDraws`, seeded from the trainer seed; the
fault fates and the sharded sampler's block draws come from their own
per-round streams. The generator cannot reproduce the reference's JAX
streams; a test hands the engine an object with the same methods that
returns the reference's draws.

:meth:`SimEngine.run` runs ``rounds_per_call`` rounds between host reads,
keeping each round's history on the device and reading it once per call.
:meth:`SimEngine.run_python` reads after every round. Both run the same
round body from the same draws, so params and history are bitwise equal.
Under fixed-size rounds the slot mask (and, with faults, the report mask)
is known on the host and a round reads nothing back; a Poisson round's
mask is made on the device and is read once per round by the streaming sum
(which skips chunks that are entirely masked).

**Cohort sharding** — ``num_shards`` / ``num_pods`` > 1 (or
``mesh_config``) run the engine on T = num_pods · num_shards ranks, one
process each (`repro_torch.launch.mesh`: ``torchrun`` or ``spawn_ranks``),
laid out pod-major on a ``(data,)`` or ``(pod, data)`` ``DeviceMesh``.
Every rank seeds the same generator and draws the whole round —
availability, the cohort, every slot's example indices, the noise — and
the fault fates, so the stream does not depend on the topology; each rank
then takes its own contiguous group of canonical blocks
(`sharding.specs.owned_rows`): it trains and folds only its slots
(`stream_block_sums` over its blocks), and under the streamed backend
stages only their rows. The round sum crosses ranks only as copies: the
raw block partials of every leaf and the (blocks, 4) stats, one float32
buffer, are all-gathered over ``data`` and folded pod by pod by
`reduction.fold_blocks`; across pods only the pod partials are gathered
and folded again (the `reduction.fold_pods` association). No collective
adds anything, so params, momentum, population vectors and history are
bitwise those of one rank for every T dividing `CANON_BLOCKS`. Under
``sampler="sharded"`` each rank holds only its population rows, draws its
blocks, selects candidates from them, gathers every rank's candidates
(`pop_sampler.gather_shards`) and merges them as every other rank does;
the global sampler runs replicated. The noise, the server step, the
verdict and the eval hook run replicated on every rank.

The streamed backend reads the cohort's ids once a round (a Poisson round's
mask rides in the same transfer). Its order of draws is the device
backend's — round k's availability, cohort, example indices and noise are
all launched before round k+1's sampling — and a CUDA generator fixes a
draw's bits when the draw is launched, so the streamed trajectory is
bitwise the device backend's on one seed. The sampler, the ids read and the
staging copy run in order on the compute stream in :meth:`SimEngine.run`
and :meth:`SimEngine.run_python` alike: the ids read waits for the previous
round's compute, and the store's rows go through one of two pinned host
buffers into one of two device buffers.
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ClientConfig, DPConfig, MeshConfig
from repro_torch.core.clipping import CLIP_PATHS
from repro_torch.core.dp_fedavg import finalize_round, server_step
from repro_torch.core.server_optim import ServerOptState, init_state
from repro_torch.data.population_store import (PopulationStore,
                                               as_population_store)
from repro_torch.data.tokenizer import PAD
from repro_torch.fl import pop_sampler
from repro_torch.fl.client import (client_updates, fold_round,
                                   local_deltas, stream_block_sums)
from repro_torch.fl.faults import FaultConfig, fault_fates, fault_generator
from repro_torch.fl.reduction import (block_sums, canon_pad, fold_blocks,
                                      n_canon_blocks, resolve_chunk)
from repro_torch.launch.mesh import all_gather_copies, make_cohort_mesh
from repro_torch.models.api import Model
from repro_torch.sharding.specs import owned_rows, sim_mesh_config
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import (tree_leaves, tree_map, tree_noise,
                                      tree_unflatten)
from repro_torch.utils.spans import count, span

__all__ = ["EngineDraws", "EngineState", "POPULATION_BACKENDS", "SAMPLERS",
           "SimEngine", "example_indices", "gather_client_batches",
           "pace_steering_weights", "poisson_select", "sample_cohort"]

POPULATION_BACKENDS = ("device", "streamed")
SAMPLERS = ("global", "sharded")

# Stand-in weight for unavailable devices: far below any real weight, so
# they are never chosen while ≥ cohort available devices exist — but rounds
# stay fixed-size when an availability draw comes up short.
_UNAVAILABLE_W = 1e-30
_NEVER = -(10 ** 9)


def pace_steering_weights(last_round, synthetic, round_idx: int,
                          cooldown: int, penalty: float) -> torch.Tensor:
    """Default weight hook — mirrors `PopulationSim.selection_weights`:
    devices that participated within ``cooldown`` rounds are deprioritized to
    ``penalty``; secret-sharer synthetic devices are exempt (paper §V-A)."""
    cooling = ((round_idx - last_round) < cooldown) & ~synthetic
    return torch.where(cooling, penalty, 1.0).to(torch.float32)


def sample_cohort(generator: torch.Generator, weights, available,
                  cohort: int) -> torch.Tensor:
    """Fixed-size weighted sampling without replacement on the generator's
    device (the weights and the availability are moved there).

    Rounds are fixed-size by construction (Algorithm 1): if a round's
    check-in draw leaves fewer than ``cohort`` devices, the remainder is
    topped up from un-checked-in devices rather than shrinking the round
    (`SimEngine` warns when a configuration makes that regime likely)."""
    dev = generator.device
    w = torch.where(available.to(dev), weights.to(dev),
                    _UNAVAILABLE_W).to(torch.float32)
    p = w / torch.sum(w)
    return torch.multinomial(p, cohort, replacement=False,
                             generator=generator)


def poisson_select(generator: torch.Generator, q: float, available,
                   buffer: int):
    """Per-device Bernoulli(q) round composition [MRTZ17] with static shapes.

    Draws ``sel[i] ~ Bernoulli(q)`` for every *available* device, then packs
    the first ``buffer`` selected device ids (index order) into a
    fixed-shape cohort buffer. Returns ``(ids (buffer,), slot_mask (buffer,)
    bool, took (N,) bool)``, ``took`` marking exactly the devices occupying a
    slot; empty slots hold id 0. Overflow beyond ``buffer`` is truncated;
    `SimEngine` sizes the buffer ≥ qN + 4·√(qN) and warns otherwise. Nothing
    is read back to the host."""
    u = torch.rand(available.shape, generator=generator,
                   device=generator.device).to(available.device)
    sel = (u < q) & available
    pos = torch.cumsum(sel.to(torch.int64), 0)
    took = sel & (pos <= buffer)
    # selected devices land at slot pos - 1; the rest in a spare last slot
    slot = torch.where(took, pos - 1, buffer)
    ids = torch.zeros((buffer + 1,), dtype=torch.int64,
                      device=available.device)
    ids.scatter_(0, slot, torch.arange(available.shape[0],
                                       device=available.device))
    slot_mask = torch.arange(buffer, device=available.device) < took.sum()
    return torch.where(slot_mask, ids[:buffer], 0), slot_mask, took


def example_indices(generator: torch.Generator, counts,
                    need: int) -> torch.Tensor:
    """(C, need) example indices, row c uniform in ``[0, counts[c])`` (with
    replacement): ``floor(u · count)`` from float64 uniforms, clamped so
    that it never yields ``count`` itself."""
    u = torch.rand((counts.shape[0], need), generator=generator,
                   dtype=torch.float64, device=generator.device
                   ).to(counts.device)
    c = counts.to(torch.int64)[:, None]
    return torch.minimum((u * c).floor().to(torch.int64), c - 1)


def gather_client_batches(examples, ids, idx, n_batches: int,
                          batch_size: int) -> Dict[str, torch.Tensor]:
    """The (C, n_batches, B, S) client batch stack by pure gathers from the
    padded corpus tensor (N, E_max, S+1): client c takes rows
    ``examples[ids[c], idx[c]]`` — the device-side analogue of
    ``FederatedDataset.user_tensor``."""
    rows = examples[ids[..., None], idx]                 # (..., need, S+1)
    rows = rows.reshape(tuple(ids.shape) + (n_batches, batch_size, -1))
    batch = {"tokens": rows[..., :-1], "labels": rows[..., 1:]}
    batch["mask"] = (batch["labels"] != PAD).to(torch.float32)
    return batch


class EngineDraws:
    """Every random draw of a round, from one ``torch.Generator`` on the
    engine's device, one method per draw. The engine calls
    :meth:`begin_round` first, then :meth:`available`, then :meth:`cohort`
    (fixed rounds) or :meth:`poisson` — under ``sampler="sharded"``
    :meth:`block_uniforms` and :meth:`block_gumbels` in their place —,
    then, with a fault model, :meth:`fates`, then :meth:`example_indices`,
    then :meth:`noise`. An object with these methods can stand in for this
    one (`SimEngine.init_state(draws=...)`) to feed the engine another
    stream's draws — the reference's, or the host trainer's.

    Each draw is made on the generator's device and the engine moves it to
    its own, so a CPU generator feeds an engine on any device: an engine on
    the card and one on the CPU, each given ``EngineDraws`` over a CPU
    generator of one seed, take the same draws.

    The block draws come from a second generator on the same device,
    reseeded per block from (the generator's initial seed, round, stream,
    block) (`fl.pop_sampler.block_seed`): they never advance the main
    generator, and a block's draws do not depend on the other blocks."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.seed = generator.initial_seed()
        self._block_gen = None

    def begin_round(self, round_idx: int) -> None:
        """One generator carries every round; nothing to split."""

    def available(self, n: int) -> torch.Tensor:
        """(n,) float32 uniforms; device i checks in when below the
        availability."""
        g = self.generator
        return torch.rand((n,), generator=g, device=g.device)

    def cohort(self, weights, available, cohort: int) -> torch.Tensor:
        return sample_cohort(self.generator, weights, available, cohort)

    def poisson(self, q: float, available, buffer: int):
        return poisson_select(self.generator, q, available, buffer)

    def _blocks(self) -> torch.Generator:
        if self._block_gen is None:
            self._block_gen = torch.Generator(device=self.generator.device)
        return self._block_gen

    def block_uniforms(self, stream: str, round_idx: int, block_ids,
                       blk: int) -> torch.Tensor:
        """(len(block_ids), blk) uniforms of the ``"available"`` or
        ``"sample"`` stream, block ``b`` from its own seed."""
        return pop_sampler.block_uniforms(
            self._blocks(), self.seed, round_idx,
            pop_sampler.STREAMS[stream], block_ids, blk)

    def block_gumbels(self, round_idx: int, block_ids, blk: int
                      ) -> torch.Tensor:
        """(len(block_ids), blk) Gumbel draws of the ``"sample"`` stream."""
        return pop_sampler.block_gumbels(self._blocks(), self.seed,
                                         round_idx, block_ids, blk)

    def fates(self, round_idx: int, n_slots: int, cfg: FaultConfig):
        """The round's fault fates, on the CPU, from the fault stream of
        ``(cfg.seed, round_idx)`` — never from the training generator."""
        return fault_fates(fault_generator(cfg.seed, round_idx), n_slots,
                           cfg)

    def example_indices(self, counts, need: int) -> torch.Tensor:
        return example_indices(self.generator, counts, need)

    def noise(self, like, std: float):
        """Gaussian noise shaped like ``like``, already scaled by ``std``."""
        return tree_noise(self.generator, like, std)


class EngineState(NamedTuple):
    """Simulation state threaded through the rounds. ``draws`` holds the
    engine's generator, which advances as rounds run: like the reference's
    donated state, a state is consumed by the run it is given to. Under
    ``sampler="sharded"`` the population vectors are padded to whole
    population blocks (``SimEngine.n_pad`` rows; padding never
    participates), and over several ranks each rank holds its own rows
    (`SimEngine.population` gathers them whole)."""

    params: object
    opt_state: ServerOptState
    draws: EngineDraws
    last_round: torch.Tensor     # (rows,) int32 — last participation
    participation: torch.Tensor  # (rows,) int32 — participation counts
    round_idx: int


class _Cohort(NamedTuple):
    """One round's selection, as the compute phase takes it."""

    ids: torch.Tensor            # (padded,) user ids; empty slots alias 0
    slot_mask: torch.Tensor      # (padded,) bool — selected slots
    report_mask: torch.Tensor    # (padded,) bool — reports the sum folds
    corrupt: Optional[torch.Tensor]  # (padded,) bool, fault model only
    idx: torch.Tensor            # (padded, need) per-slot example indices
    live: Optional[List]         # this rank's live chunks, or None


class SimEngine:
    """Multi-round DP-FedAvg simulator on one device, or over the ranks of
    a cohort mesh.

    ``data`` is the dict from ``FederatedDataset.to_device_arrays()``, or a
    `data.population_store.PopulationStore` (a ``FederatedDataset`` or a
    store's directory also serve under ``population_backend="streamed"``).
    The availability / Pace-Steering parameters mirror ``PopulationSim``;
    pass ``weight_fn(last_round, synthetic, round_idx) -> (N,) weights`` to
    replace the Pace-Steering prior.

    ``sampling`` defaults to ``dp.sampling``: ``"fixed"`` rounds of exactly
    qN devices (Algorithm 1), or ``"poisson"`` variable-size rounds (each
    available device i.i.d. Bernoulli(qN/N); Pace-Steering weights don't
    apply).

    ``population_backend``: ``"device"`` holds the whole padded corpus on
    the device; ``"streamed"`` keeps it on the host and stages one cohort a
    round (see the module docstring), bitwise the device backend's
    trajectory. ``sampler``: ``"global"`` or ``"sharded"`` (the block-keyed
    Gumbel top-k of `fl.pop_sampler`).

    ``cohort_chunk`` streams the round ``cohort_chunk`` clients at a time
    (it must divide the block size, padded cohort / 8); ``None``
    auto-selects; ``0`` is the materializing path. ``clip_path`` selects
    the clip→accumulate: ``"fused"`` (the CUDA dp_clip kernels) or
    ``"tree"`` (plain tensor ops).

    ``num_shards`` / ``num_pods`` (or ``mesh_config``, a ``("data",)`` or
    ``("pod", "data")`` `configs.base.MeshConfig`) shard the cohort over
    that many ranks; the process group must be running with exactly that
    many (see the module docstring). On one card the ranks share it on
    ``gloo``.

    ``device`` (default ``cuda``; raises without a GPU) holds the corpus
    (or the staged cohorts), the population vectors and the generator."""

    def __init__(self, model: Model, data, dp: DPConfig,
                 client: ClientConfig, *,
                 n_local_batches: int = 4, availability: float = 0.1,
                 pace_cooldown: int = 50, pace_penalty: float = 0.01,
                 rounds_per_call: int = 8,
                 weight_fn: Optional[Callable] = None,
                 sampling: Optional[str] = None,
                 poisson_buffer: Optional[int] = None,
                 num_shards: int = 1, num_pods: int = 1,
                 mesh_config: Optional[MeshConfig] = None,
                 cohort_chunk: Optional[int] = None,
                 clip_path: str = "fused",
                 population_backend: str = "device",
                 sampler: str = "global",
                 fault_config=None,
                 eval_fn: Optional[Callable] = None, eval_every: int = 1,
                 device=None):
        if mesh_config is not None:
            axes = tuple(mesh_config.axes)
            if axes not in (("data",), ("pod", "data")):
                raise ValueError(
                    "SimEngine shards the cohort over its batch axes only "
                    f"— a ('data',) or ('pod', 'data') mesh; got "
                    f"{mesh_config}. Model-parallel axes are the launch "
                    "layer's job — pass sim_mesh_config(num_shards, "
                    "num_pods) or just num_shards/num_pods.")
            sizes = dict(zip(axes, mesh_config.shape))
            from_mesh, from_mesh_pods = sizes["data"], sizes.get("pod", 1)
            if num_shards not in (1, from_mesh):
                raise ValueError(
                    f"num_shards={num_shards} disagrees with mesh_config's "
                    f"data axis ({from_mesh} devices); pass one or the "
                    "other")
            if num_pods not in (1, from_mesh_pods):
                raise ValueError(
                    f"num_pods={num_pods} disagrees with mesh_config's pod "
                    f"axis ({from_mesh_pods} pods); pass one or the other")
            num_shards, num_pods = from_mesh, from_mesh_pods
        if population_backend not in POPULATION_BACKENDS:
            raise ValueError(f"population_backend must be one of "
                             f"{POPULATION_BACKENDS}, got "
                             f"{population_backend!r}")
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, "
                             f"got {sampler!r}")
        if clip_path not in CLIP_PATHS:
            raise ValueError(f"clip_path must be one of {CLIP_PATHS}, "
                             f"got {clip_path!r}")
        self.device = resolve_device(device)
        self.num_shards, self.num_pods = int(num_shards), int(num_pods)
        # ranks the cohort shards over, pod-major
        self.total_shards = self.num_pods * self.num_shards
        self.mesh = (make_cohort_mesh(sim_mesh_config(self.num_shards,
                                                      self.num_pods),
                                      self.device.type)
                     if self.total_shards > 1 else None)
        self.rank = (pop_sampler.shard_rank(self.mesh)
                     if self.mesh is not None else 0)
        self.model = model
        self.dp = dp
        self.client = client
        self.n_local_batches = n_local_batches
        self.availability = availability
        self.rounds_per_call = max(int(rounds_per_call), 1)
        self.sampling = sampling or dp.sampling
        if self.sampling not in ("fixed", "poisson"):
            raise ValueError(f"sampling must be 'fixed' or 'poisson', "
                             f"got {self.sampling!r}")
        self.clip_path = clip_path
        self.eval_fn = eval_fn
        self.eval_every = max(int(eval_every), 1)
        self._eval_like = None
        self.population_backend = population_backend
        self.sampler = sampler
        if population_backend == "device":
            if isinstance(data, PopulationStore):
                data = data.device_arrays()
            self.store = None
            self.examples = torch.as_tensor(np.asarray(data["examples"]),
                                            dtype=torch.int32
                                            ).to(self.device)
            counts, synth_np = data["counts"], data["synthetic"]
        else:
            # the corpus stays on the host: only the per-user vectors and
            # the two staged cohorts reach the device
            self.store = as_population_store(data)
            self.examples = None
            counts, synth_np = self.store.counts, self.store.synthetic
        self.counts = torch.as_tensor(np.asarray(counts),
                                      dtype=torch.int32).to(self.device)
        synth_np = np.asarray(synth_np, bool)
        self.synthetic = torch.from_numpy(synth_np).to(self.device)
        self.n_users = int(synth_np.shape[0])
        self.cohort = min(dp.clients_per_round, self.n_users)
        self.q = self.cohort / self.n_users
        if sampler == "sharded":
            # the population axis in whole canonical blocks; the vectors,
            # the synthetic mask and the validity mask are padded to it,
            # and this rank holds its own rows of each
            self.pop_blocks = pop_sampler.n_pop_blocks(self.num_shards,
                                                       self.num_pods)
            self.n_pad = pop_sampler.pop_pad(self.n_users, self.num_shards,
                                             self.num_pods)
            lo, hi = owned_rows(self.n_pad, self.rank, self.total_shards)
            self._pop_rows = (lo, hi)
            nb = self.pop_blocks // self.total_shards
            self._pop_block_ids = range(self.rank * nb, (self.rank + 1) * nb)
            self._valid = (torch.arange(lo, hi) < self.n_users).to(
                self.device)
            self._synth_pad = torch.nn.functional.pad(
                self.synthetic, (0, self.n_pad - self.n_users))[lo:hi]
        else:
            self.pop_blocks = None
            self.n_pad = self.n_users
        # Δ̄ and σ divide by qN: the exact fixed round size, the expected
        # Poisson one [MRTZ17]; under the fault model by the report goal,
        # and the round over-selects so that the expected survivor count
        # is qN. Without faults every quantity is its fault-free value.
        self.faults = fault_config
        if fault_config is not None:
            self.report_goal = fault_config.resolve_report_goal(self.cohort)
            self.sel_cohort = min(self.n_users,
                                  fault_config.over_selection(self.cohort))
            self.sel_q = (min(1.0, self.q / fault_config.expected_survival)
                          if fault_config.over_select else self.q)
            self._round_denom = self.report_goal
        else:
            self.report_goal = None
            self.sel_cohort = self.cohort
            self.sel_q = self.q
            self._round_denom = self.cohort
        if self.sampling == "poisson":
            exp_sel = (self.cohort if fault_config is None
                       else self.sel_q * self.n_users)
            buf = poisson_buffer or int(np.ceil(
                exp_sel + 4.0 * np.sqrt(exp_sel) + 4))
            # pad, never truncate: the buffer grows to whole blocks
            self.buffer = canon_pad(min(self.n_users, buf), self.num_shards,
                                    self.num_pods)
            if self.buffer < self.cohort + 2 * np.sqrt(self.cohort) \
                    and self.buffer < self.n_users:
                warnings.warn(
                    f"SimEngine: poisson_buffer={self.buffer} is within 2σ "
                    f"of the expected round size qN={self.cohort}; rounds "
                    "will regularly be truncated (the clipped sum silently "
                    "drops the overflow). Raise poisson_buffer.",
                    stacklevel=2)
            self.padded = self.buffer
        else:
            self.buffer = self.sel_cohort
            self.padded = canon_pad(self.sel_cohort, self.num_shards,
                                    self.num_pods)
        self.n_blocks = n_canon_blocks(self.num_shards, self.num_pods)
        # this rank's cohort slots: a contiguous group of whole blocks
        self._slots = slice(*owned_rows(self.padded, self.rank,
                                        self.total_shards))
        self._n_slots = self.padded // self.total_shards
        self.cohort_chunk = resolve_chunk(cohort_chunk,
                                          self.padded // self.n_blocks)
        if fault_config is not None:
            if self.cohort_chunk == 0:
                raise ValueError(
                    "fault_config needs the streaming accumulation path "
                    "(cohort_chunk > 0): corrupt-report rejection lives in "
                    "the per-slot fold's guard_nonfinite — the materializing "
                    "cohort_chunk=0 path is the fault-free reference only")
            max_survivors = (self.sel_cohort if self.sampling == "fixed"
                             else self.padded)
            if self.report_goal > max_survivors:
                warnings.warn(
                    f"SimEngine: report_goal={self.report_goal} exceeds the "
                    f"per-round selection ({max_survivors} slots) — every "
                    "round will abort and the run can never make progress. "
                    "Lower report_goal or enable over_select.", stacklevel=2)
        n_synth = int(synth_np.sum())
        expected_avail = availability * (self.n_users - n_synth) + n_synth
        if self.sampling == "fixed" and expected_avail < self.sel_cohort:
            warnings.warn(
                f"SimEngine: expected check-ins ({expected_avail:.0f} = "
                f"{availability}·{self.n_users - n_synth} real + {n_synth} "
                f"synthetic) < cohort ({self.sel_cohort}); fixed-size rounds "
                "will regularly be topped up from un-checked-in devices and "
                "σ = zS/qN assumes the full cohort. Raise availability / "
                "population or lower clients_per_round.", stacklevel=2)
        if self.sampling == "poisson" \
                and self.q * expected_avail < 0.9 * self.cohort:
            warnings.warn(
                f"SimEngine: Poisson rounds select Bernoulli(q={self.q:.3g})"
                f" among *available* devices — expected realized round size "
                f"({self.q * expected_avail:.0f}) is well below qN "
                f"({self.cohort}) while σ = zS/qN assumes qN. Per-round SNR "
                "will be worse than the DPConfig calibration implies; raise "
                "availability (MRTZ17 assumes the whole population is "
                "available) or lower clients_per_round.", stacklevel=2)
        self.weight_fn = weight_fn or (
            lambda last, synth, r: pace_steering_weights(
                last, synth, r, pace_cooldown, pace_penalty))
        # fixed rounds: the slot mask, and which chunks are live, are known
        # on the host, so a round reads nothing back
        self._fixed_host = torch.arange(self.padded) < self.sel_cohort
        self._fixed_mask = self._fixed_host.to(self.device)
        self._fixed_live = self._live(self._fixed_host[self._slots])
        self._staging = None

    def _live(self, host_mask: torch.Tensor):
        """Which chunks of this rank's streaming sum hold an unmasked slot,
        from its slots' mask on the host (None on the materializing
        path)."""
        if self.cohort_chunk == 0:
            return None
        return host_mask.reshape(self._shape3()).any(-1).tolist()

    def _shape3(self) -> Tuple[int, int, int]:
        """(blocks, chunks per block, chunk) of this rank's slots."""
        chunk, nb = self.cohort_chunk, self.n_blocks // self.total_shards
        return (nb, self._n_slots // (nb * chunk), chunk)

    @property
    def corpus_device_bytes(self) -> int:
        """Bytes of corpus on the device: the whole padded corpus (device
        backend) or the two staged cohort buffers (streamed backend, 0
        before the first streamed round)."""
        if self.examples is not None:
            return self.examples.numel() * self.examples.element_size()
        if self._staging is None:
            return 0
        return sum(b.numel() * b.element_size()
                   for b in self._staging["device"])

    # ------------------------------------------------------------------ state

    def init_state(self, params, seed: int = 0,
                   opt_state: Optional[ServerOptState] = None,
                   draws=None) -> EngineState:
        """Initial state: ``params`` on the engine's device, a fresh
        optimizer state (or ``opt_state``), and ``draws`` — by default an
        :class:`EngineDraws` over a generator on the device seeded with
        ``seed``. Over several ranks every rank passes the same."""
        params = tree_map(lambda l: l.detach().to(self.device),
                          strip_compute(params))
        if draws is None:
            draws = EngineDraws(torch.Generator(device=self.device)
                                .manual_seed(seed))
        n = (self._pop_rows[1] - self._pop_rows[0]
             if self.sampler == "sharded" else self.n_users)
        return EngineState(
            params=params,
            opt_state=opt_state if opt_state is not None
            else init_state(params),
            draws=draws,
            last_round=torch.full((n,), _NEVER, dtype=torch.int32,
                                  device=self.device),
            participation=torch.zeros((n,), dtype=torch.int32,
                                      device=self.device),
            round_idx=0)

    # ----------------------------------------------------------------- ranks

    def _gather(self, x: torch.Tensor, axis: Optional[str] = None
                ) -> torch.Tensor:
        """``x`` of every rank, pod-major (``axis`` None: over both axes,
        `pop_sampler.gather_shards`), or over one mesh axis; identity on
        one rank. The ``engine.gather`` span starts once this rank's queued
        work is done; the bytes received go to the ``gather_bytes``
        counter."""
        if self.mesh is None:
            return x
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with span("engine.gather"):
            out = (pop_sampler.gather_shards(x, self.mesh) if axis is None
                   else all_gather_copies(x, self.mesh.get_group(axis)))
        count("gather_bytes", out.numel() * out.element_size())
        return out

    def population(self, vec: torch.Tensor) -> torch.Tensor:
        """A whole population vector from this rank's rows of it (gathered
        from every rank under the sharded sampler over several ranks; every
        rank must call it), else ``vec`` itself."""
        if self.mesh is None or self.sampler != "sharded":
            return vec
        return pop_sampler.gather_shards(vec, self.mesh)

    def local_rows(self, vec: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole population vector."""
        if self.sampler != "sharded":
            return vec
        return vec[self._pop_rows[0]:self._pop_rows[1]]

    # ------------------------------------------------------------- round body

    def _sharded_avail(self, d, r: int) -> torch.Tensor:
        """(rows,) check-ins of this rank's population rows, from the
        ``available`` stream's block uniforms; padding rows never check
        in."""
        blk = self.n_pad // self.pop_blocks
        u = d.block_uniforms("available", r, self._pop_block_ids, blk)
        return ((u.to(self.device).reshape(-1) < self.availability)
                | self._synth_pad) & self._valid

    def _sharded_score(self, d, r: int, last_round,
                       avail=None) -> torch.Tensor:
        """(rows,) Gumbel scores log(weight) + g of a fixed round on this
        rank's rows (weight 1e-30 for devices that did not check in). The
        block draws never advance the training generator, so a round's
        scores can be drawn again."""
        if avail is None:
            avail = self._sharded_avail(d, r)
        blk = self.n_pad // self.pop_blocks
        w = self.weight_fn(last_round, self._synth_pad, r)
        g = d.block_gumbels(r, self._pop_block_ids, blk)
        return torch.log(torch.where(avail, w.to(torch.float32),
                                     _UNAVAILABLE_W)) \
            + g.to(self.device).reshape(-1)

    def _select_sharded(self, d, r: int, last_round):
        """The block-keyed selection of `fl.pop_sampler` (the reference's
        ``_pop_shard_body``): this rank's availability, then the top
        candidates of its rows (fixed rounds) or its packed selected rows
        (Poisson rounds), every rank's candidates gathered and merged.
        Returns ``(ids (padded,), slot_mask (padded,))``, the same on every
        rank."""
        avail = self._sharded_avail(d, r)
        offset = self._pop_rows[0]
        if self.sampling == "poisson":
            blk = self.n_pad // self.pop_blocks
            u = d.block_uniforms("sample", r, self._pop_block_ids, blk)
            sel = (u.to(self.device).reshape(-1) < self.sel_q) & avail
            gids, cnt = pop_sampler.pack_selected(sel, self.padded, offset)
            return pop_sampler.merge_poisson(self._gather(gids),
                                             self._gather(cnt.reshape(1)),
                                             self.padded)
        score = self._sharded_score(d, r, last_round, avail)
        skey = torch.where(self._valid, pop_sampler.sortable_f32(score),
                           pop_sampler.INT32_MIN)
        vals, lidx = pop_sampler.blocked_topk(
            skey, min(self.sel_cohort, skey.shape[0]))
        ids = pop_sampler.merge_topk(self._gather(vals),
                                     self._gather(lidx + offset),
                                     self.sel_cohort)
        return (torch.nn.functional.pad(ids, (0, self.padded
                                              - self.sel_cohort)),
                self._fixed_mask)

    def _sample_phase(self, d, last_round, participation, r: int):
        """Availability, cohort selection, the fault fates and the
        population vectors' update, then the per-slot example indices.
        Returns ``(last_round, participation, cohort)``: without faults the
        cohort's ``report_mask`` is its ``slot_mask`` and ``corrupt`` None;
        ``live`` is the host list of this rank's live chunks (fixed
        rounds) or None (read from the mask). Every draw covers the whole
        padded cohort, on every rank."""
        with span("engine.sample"):
            d.begin_round(r)
            took = None
            if self.sampler == "sharded":
                ids, slot_mask = self._select_sharded(d, r, last_round)
            else:
                avail = (d.available(self.n_users).to(self.device)
                         < self.availability) | self.synthetic
                if self.sampling == "poisson":
                    ids, slot_mask, took = d.poisson(self.sel_q, avail,
                                                     self.padded)
                    ids, slot_mask = ids.to(self.device), slot_mask.to(
                        self.device)
                    took = took.to(self.device)
                else:
                    w = self.weight_fn(last_round, self.synthetic, r)
                    ids = d.cohort(w, avail, self.sel_cohort).to(self.device)
                    ids = torch.nn.functional.pad(
                        ids, (0, self.padded - self.sel_cohort))
                    slot_mask = self._fixed_mask
            live = self._fixed_live if self.sampling == "fixed" else None
            if self.faults is None:
                report_mask, corrupt = slot_mask, None
            else:
                # slot-level fates from the fault stream, on the host: a
                # fixed round's live chunks follow from them without a
                # device read
                fates = d.fates(r, self.padded, self.faults)
                reported = fates.reported.cpu()
                report_mask = slot_mask & reported.to(self.device)
                corrupt = report_mask & fates.corrupt.to(self.device)
                if live is not None:
                    live = self._live(
                        (self._fixed_host & reported)[self._slots])
            part_mask = slot_mask if self.faults is None else report_mask
            if self.sampler == "sharded":
                # O(cohort) masked scatters into this rank's rows:
                # last_round reacts to selection, participation to the
                # reports that arrived
                offset = self._pop_rows[0]
                last_round = pop_sampler.scatter_max(last_round, ids,
                                                     slot_mask, r, offset)
                participation = pop_sampler.scatter_add(participation, ids,
                                                        part_mask, offset)
            elif self.sampling == "poisson":
                last_round = torch.where(took, r, last_round).to(torch.int32)
                if self.faults is None:
                    participation = participation + took.to(torch.int32)
                else:
                    participation = participation.index_add(
                        0, ids, report_mask.to(torch.int32))
            else:
                # padded slots alias device 0: scatter through the mask so
                # they never touch the population vectors
                last_round = last_round.scatter_reduce(
                    0, ids,
                    torch.where(slot_mask, r, _NEVER).to(torch.int32),
                    reduce="amax")
                participation = participation.index_add(
                    0, ids, part_mask.to(torch.int32))
            need = self.n_local_batches * self.client.batch_size
            idx = d.example_indices(self.counts[ids], need).to(self.device)
            return last_round, participation, _Cohort(
                ids, slot_mask, report_mask, corrupt, idx, live)

    def _block_sums(self, params, examples, ids, idx, mask, live,
                    corrupt=None):
        """This rank's canonical block partials of the masked clipped sum
        and of its stats ([Σ norms, Σ clipped flags, Σ losses, Σ mask] a
        block), over its slots. Client ``c`` takes rows ``examples[ids[c],
        idx[c]]``: the corpus and the user ids (device backend), or a
        staged cohort and the slot numbers (streamed backend). ``corrupt``
        (fault model) marks the slots whose reports are non-finite garbage:
        their deltas and losses are multiplied by NaN (clean slots by 1,
        which changes no bit) and the fold rejects them
        (``guard_nonfinite``). Returns ``(partials with a leading (blocks,)
        axis, (blocks, 4) stats)``."""
        nb, B = self.n_local_batches, self.client.batch_size
        if self.cohort_chunk == 0:
            # every clipped update at once, then one sum a block
            n_blocks = self.n_blocks // self.total_shards
            batches = gather_client_batches(examples, ids, idx, nb, B)
            clipped, norms, flags, losses = client_updates(
                self.model, params, batches, self.client, self.dp)
            m = mask.to(torch.float32)
            partials = tree_map(
                lambda *ls: block_sums(torch.stack(ls).to(torch.float32)
                                       * m.reshape((-1,) + (1,) * ls[0].dim()),
                                       n_blocks), *clipped)
            stats = block_sums(torch.stack([norms * m, flags * m, losses * m,
                                            m], dim=-1), n_blocks)
            return partials, stats
        shape3 = self._shape3()
        inputs = {"ids": ids.reshape(shape3),
                  "idx": idx.reshape(shape3 + (idx.shape[-1],))}
        if corrupt is not None:
            inputs["bad"] = corrupt.to(torch.float32).reshape(shape3)

        def compute_chunk(inp):
            with span("client.gather"):
                batches = gather_client_batches(examples, inp["ids"],
                                                inp["idx"], nb, B)
            deltas, losses = local_deltas(self.model, params, batches,
                                          self.client)
            if corrupt is None:
                return deltas, losses
            poison = torch.where(inp["bad"] > 0, float("nan"), 1.0)
            deltas = [tree_map(lambda l, p=p: l * p, d)
                      for d, p in zip(deltas, poison)]
            return deltas, losses * poison

        return stream_block_sums(
            compute_chunk, inputs, mask.to(torch.float32).reshape(shape3),
            params, self.dp.clip_norm, clip_path=self.clip_path,
            guard_nonfinite=corrupt is not None, live=live)

    def _fold_ranks(self, partials, stats):
        """Every rank's block partials → the round's sum, mean norm,
        clipped fraction, mean loss and accepted count (`fold_round`). Over
        several ranks the partials and stats travel as one float32 buffer
        a block: gathered over ``data``, folded pod by pod, and only the
        pod partials gathered over ``pod`` and folded again — copies and
        the canonical tree, never a sum inside a collective."""
        with span("engine.fold"):
            if self.mesh is None:
                return fold_round(partials, stats)
            leaves = tree_leaves(partials)
            nb = stats.shape[0]
            flat = torch.cat([l.reshape(nb, -1) for l in leaves] + [stats],
                             1)
            folded = fold_blocks(self._gather(flat, "data"))
            if self.num_pods > 1:
                folded = fold_blocks(self._gather(folded[None], "pod"))
            sizes = [l[0].numel() for l in leaves] + [4]
            parts = torch.split(folded, sizes)
            total = tree_unflatten(partials, [p.reshape(l.shape[1:])
                                              for p, l in zip(parts, leaves)])
            s = parts[-1]
            denom = torch.clamp(s[3], min=1.0)
            return total, s[0] / denom, s[1] / denom, s[2] / denom, s[3]

    def _compute_phase(self, params, opt_state, draws, r: int,
                       cohort: _Cohort, examples, slot_ids):
        """The round's clipped sum, noise, server step and record, from a
        cohort and the rows this rank's slots gather from
        (``examples[slot_ids[c]]``, ``slot_ids`` of this rank's slots)."""
        sl = self._slots
        with span("engine.compute"):
            total, mean_norm, frac, loss, accepted = self._fold_ranks(
                *self._block_sums(
                    params, examples, slot_ids, cohort.idx[sl],
                    cohort.report_mask[sl], cohort.live,
                    None if cohort.corrupt is None else cohort.corrupt[sl]))
            std = self.dp.noise_multiplier * self.dp.clip_norm \
                / float(self._round_denom)
            with span("server.step"):
                # the noise is drawn whether or not the round commits, so
                # that no later draw depends on the verdict
                delta, _ = finalize_round(total, self._round_denom, None,
                                          self.dp, stats=(mean_norm, frac),
                                          noise=draws.noise(total, std))
                new_params, new_opt = server_step(params, opt_state, delta,
                                                  self.dp)
            n_selected = cohort.slot_mask.sum().to(torch.int32)
            rec = {"loss": loss, "mean_update_norm": mean_norm,
                   "frac_clipped": frac, "noise_std": std,
                   "n_clients": n_selected}
            if self.faults is not None:
                # commit iff the accepted reports reach the goal, decided on
                # the device: an aborted round keeps every old leaf's bits
                committed = accepted >= float(self.report_goal)
                new_params, new_opt = _select(
                    committed, (new_params, new_opt), (params, opt_state))
                rec.update(n_clients=accepted.to(torch.int32),
                           n_selected=n_selected,
                           n_reported=cohort.report_mask.sum().to(
                               torch.int32),
                           committed=committed)
            if self.eval_fn is not None:
                rec["eval_mask"] = (r + 1) % self.eval_every == 0
                if rec["eval_mask"]:
                    with torch.no_grad():
                        rec["eval"] = self.eval_fn(new_params, r)
            return new_params, new_opt, rec

    def _round(self, state: EngineState) -> Tuple[EngineState, Dict]:
        r = state.round_idx
        with span("engine.round", round=r):
            last_round, participation, cohort = self._sample_phase(
                state.draws, state.last_round, state.participation, r)
            params, opt_state, rec = self._compute_phase(
                state.params, state.opt_state, state.draws, r, cohort,
                self.examples, cohort.ids[self._slots])
        return EngineState(params, opt_state, state.draws, last_round,
                           participation, r + 1), rec

    # ------------------------------------------------------------- streaming

    def _ensure_staging(self) -> Dict:
        """Two device cohort buffers of (this rank's slots, E_max,
        seq_len+1) int32; on a CUDA engine also two pinned host buffers of
        that shape, a pinned buffer for the ids read, and per buffer the
        events that order its reuse."""
        if self._staging is None:
            shape = (self._n_slots, self.store.emax, self.store.row_len)
            st = {"device": [torch.empty(shape, dtype=torch.int32,
                                         device=self.device)
                             for _ in range(2)],
                  "slots": torch.arange(self._n_slots, device=self.device)}
            if self.device.type == "cuda":
                st.update(
                    host=[torch.empty(shape, dtype=torch.int32,
                                      pin_memory=True) for _ in range(2)],
                    ids=torch.empty((2 * self._n_slots,),
                                    dtype=torch.int64, pin_memory=True),
                    # copied[i]: the copy out of host[i] is done;
                    # consumed[i]: the compute that read device[i] is done
                    copied=[torch.cuda.Event() for _ in range(2)],
                    consumed=[torch.cuda.Event() for _ in range(2)])
            self._staging = st
        return self._staging

    def _read_cohort(self, cohort: _Cohort) -> torch.Tensor:
        """The round's one host read: this rank's slots' ids, and under
        Poisson rounds their report mask in the same transfer. On a CUDA
        engine it goes through a pinned buffer and waits for the current
        stream alone."""
        count("host_reads")
        sl = self._slots
        payload = cohort.ids[sl]
        if self.sampling == "poisson":
            payload = torch.cat([payload,
                                 cohort.report_mask[sl].to(torch.int64)])
        if self.device.type != "cuda":
            return payload
        host = self._ensure_staging()["ids"][:payload.numel()]
        host.copy_(payload, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return host

    def _sample_and_stage(self, d, last_round, participation, r: int,
                          slot: int):
        """Round ``r``'s sample phase, its host read, the gather of this
        rank's slots' rows from the store and their copy into device buffer
        ``slot``, in order on the current stream. On a CUDA engine the
        compute that reads device buffer ``slot`` must then record
        ``staging["consumed"][slot]``."""
        st = self._ensure_staging()
        last_round, participation, cohort = self._sample_phase(
            d, last_round, participation, r)
        host = self._read_cohort(cohort)
        n = self._n_slots
        ids = host[:n].numpy()
        if self.sampling == "poisson":
            cohort = cohort._replace(live=self._live(host[n:2 * n] > 0))
        with span("engine.stage"):
            rows = self.store.gather(ids)
            if self.device.type != "cuda":
                st["device"][slot].copy_(torch.from_numpy(rows))
                return last_round, participation, cohort
            # host[slot] is free once its last copy has run; device[slot]
            # once the compute that read it two rounds ago has
            stream = torch.cuda.current_stream(self.device)
            st["copied"][slot].synchronize()
            np.copyto(st["host"][slot].numpy(), rows)
            stream.wait_event(st["consumed"][slot])
            st["device"][slot].copy_(st["host"][slot], non_blocking=True)
            st["copied"][slot].record(stream)
        return last_round, participation, cohort

    def _run_streamed(self, state: EngineState, n_rounds: int,
                      per_call: int):
        """The streamed backend's round loop: sample and stage round r, then
        launch its compute, ``per_call`` rounds between history reads."""
        cuda = self.device.type == "cuda"
        st = self._ensure_staging()
        last_round, participation = state.last_round, state.participation
        params, opt_state, r = state.params, state.opt_state, \
            state.round_idx
        hists, recs = [], []
        for _ in range(n_rounds):
            slot = r % 2
            with span("engine.round", round=r):
                last_round, participation, cohort = self._sample_and_stage(
                    state.draws, last_round, participation, r, slot)
                params, opt_state, rec = self._compute_phase(
                    params, opt_state, state.draws, r, cohort,
                    st["device"][slot], st["slots"])
                if cuda:
                    st["consumed"][slot].record()
            r += 1
            recs.append(rec)
            if len(recs) == per_call:
                hists.append(self._read(recs, params))
                recs = []
        if recs:
            hists.append(self._read(recs, params))
        return EngineState(params, opt_state, state.draws, last_round,
                           participation, r), _concat(hists)

    def run_sampler(self, state: EngineState, n_rounds: int) -> EngineState:
        """The sample phase alone, ``n_rounds`` times (its time per round is
        the round's sampling share): selection, the population vectors'
        update and the example indices — with the streamed backend's host
        read of the ids —, then the round's noise draw, so that the
        generator ends where full rounds leave it. No staging, no compute;
        params and optimizer state are passed through."""
        last_round, participation = state.last_round, state.participation
        r = state.round_idx
        std = self.dp.noise_multiplier * self.dp.clip_norm \
            / float(self._round_denom)
        for _ in range(n_rounds):
            last_round, participation, cohort = self._sample_phase(
                state.draws, last_round, participation, r)
            if self.store is not None:
                self._read_cohort(cohort)
            state.draws.noise(state.params, std)
            r += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return EngineState(state.params, state.opt_state, state.draws,
                           last_round, participation, r)

    # --------------------------------------------------------------- history

    def _eval_zeros(self, recs: List[Dict], params) -> Dict:
        """Zeros shaped like ``eval_fn``'s output, for the rounds it skips.
        Its structure is learned from its first output — or, before any
        round was evaluated, from one call on ``params``."""
        if self._eval_like is None:
            done = [rec["eval"] for rec in recs if "eval" in rec]
            with torch.no_grad():
                out = done[0] if done else self.eval_fn(params, 0)
            self._eval_like = tree_map(torch.zeros_like, out)
        return self._eval_like

    def _read(self, recs: List[Dict], params) -> Dict[str, np.ndarray]:
        """Stack a call's round records and bring every device value to the
        host in one transfer."""
        with span("engine.read"):
            if self.eval_fn is not None:
                zeros = self._eval_zeros(recs, params)
                for rec in recs:
                    rec.setdefault("eval", zeros)
            keys = ("loss", "mean_update_norm", "frac_clipped", "n_clients")
            if self.faults is not None:
                keys += ("n_selected", "n_reported", "committed")
            cols = [torch.stack([rec[k] for rec in recs]) for k in keys]
            if self.eval_fn is not None:
                cols += [torch.stack(ls) for ls in zip(*(
                    [rec["eval"][k] for k in sorted(rec["eval"])]
                    for rec in recs))]
            count("host_reads")
            flat = torch.cat([c.reshape(-1).to(torch.float64) for c in cols]
                             ).cpu().numpy()
        out, at = [], 0
        for c in cols:
            n = c.numel()
            out.append(flat[at:at + n].reshape(tuple(c.shape)).astype(
                str(c.dtype).replace("torch.", "")))
            at += n
        hist = dict(zip(keys, out[:len(keys)]))
        hist["noise_std"] = np.asarray([rec["noise_std"] for rec in recs],
                                       np.float32)
        if self.eval_fn is not None:
            names = sorted(recs[0]["eval"])
            hist["eval"] = dict(zip(names, out[len(keys):]))
            hist["eval_mask"] = np.asarray([rec["eval_mask"] for rec in recs])
        return hist

    # ------------------------------------------------------------------ entry

    def run(self, state: EngineState, n_rounds: int
            ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """``rounds_per_call`` rounds between host reads: each round's
        record stays on the device until the call's rounds are done. Returns
        (state, history with a leading (n_rounds,) axis — the training
        metrics, and ``eval`` / ``eval_mask`` when a hook is set)."""
        return self._run(state, n_rounds, self.rounds_per_call)

    def run_python(self, state: EngineState, n_rounds: int
                   ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """The same rounds from the same draws, read after every round:
        params and history are bitwise those of :meth:`run`."""
        return self._run(state, n_rounds, 1)

    def _run(self, state: EngineState, n_rounds: int, per_call: int):
        if n_rounds <= 0:
            return state, {}
        with span("engine.call"):
            if self.store is not None:
                return self._run_streamed(state, n_rounds, per_call)
            hists = []
            left = n_rounds
            while left > 0:
                recs = []
                for _ in range(min(per_call, left)):
                    state, rec = self._round(state)
                    recs.append(rec)
                hists.append(self._read(recs, state.params))
                left -= len(recs)
            return state, _concat(hists)


def _select(committed: torch.Tensor, new, old):
    """``(params, opt_state)``: each leaf ``new`` where ``committed``, else
    ``old`` — bitwise either one. The optimizer's step count becomes a
    device scalar."""
    pick = lambda n, o: torch.where(committed, n, o)  # noqa: E731
    (p_new, s_new), (p_old, s_old) = new, old
    count = pick(*(torch.as_tensor(c, device=committed.device)
                   for c in (s_new.count, s_old.count)))
    return tree_map(pick, p_new, p_old), ServerOptState(
        tree_map(pick, s_new.momentum, s_old.momentum),
        tree_map(pick, s_new.nu, s_old.nu), count)


def _concat(hists: List[Dict]) -> Dict:
    out = {}
    for k, v in hists[0].items():
        if isinstance(v, dict):
            out[k] = _concat([h[k] for h in hists])
        else:
            out[k] = np.concatenate([h[k] for h in hists])
    return out
