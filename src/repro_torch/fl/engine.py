"""Multi-round DP-FedAvg simulation engine on one device (the reference's
``fl/engine.py``, its ``device`` population backend and ``global``
sampler).

The host trainer (`repro_torch.fl.round.FederatedTrainer`,
``backend="host"``) samples cohorts and stacks client tensors with numpy
every round. This engine keeps the whole simulation on the device:

* **population** — per-round availability draws and Pace Steering weights
  computed on the device from a ``last_round`` vector (the weight function
  is a hook, see :func:`pace_steering_weights`);
* **sampling** — fixed-size weighted sampling without replacement
  (:func:`sample_cohort`, ``torch.multinomial``; unavailable devices carry
  weight 1e-30, so they are chosen only when fewer than ``cohort`` devices
  checked in), or Poisson rounds (:func:`poisson_select`): every available
  device i.i.d. Bernoulli(q = qN/N), the first ``buffer`` of them packed
  into a fixed-shape cohort buffer with a slot mask;
* **data** — client batches gathered from the padded corpus tensor of
  ``FederatedDataset.to_device_arrays()`` by per-slot example indices drawn
  uniformly in ``[0, counts[u])`` (:func:`gather_client_batches`); no host
  data movement after construction;
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
fault fates alone come from their own stream. The
generator cannot reproduce the reference's JAX streams; a test hands the
engine an object with the same methods that returns the reference's draws.

:meth:`SimEngine.run` runs ``rounds_per_call`` rounds between host reads,
keeping each round's history on the device and reading it once per call.
:meth:`SimEngine.run_python` reads after every round. Both run the same
round body from the same draws, so params and history are bitwise equal.
Under fixed-size rounds the slot mask (and, with faults, the report mask)
is known on the host and a round reads nothing back; a Poisson round's
mask is made on the device and is read once per round by the streaming sum
(which skips chunks that are entirely masked).

Not ported (they raise): cohort sharding over devices (``num_shards`` /
``num_pods`` > 1), the streamed population backend and the sharded sampler
(ROADMAP.md, queue A, item 5).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ClientConfig, DPConfig
from repro_torch.core.clipping import CLIP_PATHS
from repro_torch.core.dp_fedavg import finalize_round, server_step
from repro_torch.core.server_optim import ServerOptState, init_state
from repro_torch.data.tokenizer import PAD
from repro_torch.fl.client import (fold_round, local_deltas,
                                   round_compute, stream_block_sums)
from repro_torch.fl.faults import FaultConfig, fault_fates, fault_generator
from repro_torch.fl.reduction import CANON_BLOCKS, canon_pad, resolve_chunk
from repro_torch.models.api import Model
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import tree_map, tree_noise

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
    (fixed rounds) or :meth:`poisson`, then, with a fault model,
    :meth:`fates`, then :meth:`example_indices`, then :meth:`noise`. An
    object with these methods can stand in for this one
    (`SimEngine.init_state(draws=...)`) to feed the engine another stream's
    draws — the reference's, or the host trainer's.

    Each draw is made on the generator's device and the engine moves it to
    its own, so a CPU generator feeds an engine on any device: an engine on
    the card and one on the CPU, each given ``EngineDraws`` over a CPU
    generator of one seed, take the same draws."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

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
    donated state, a state is consumed by the run it is given to."""

    params: object
    opt_state: ServerOptState
    draws: EngineDraws
    last_round: torch.Tensor     # (N,) int32 — last participation
    participation: torch.Tensor  # (N,) int32 — participation counts
    round_idx: int


class SimEngine:
    """Multi-round DP-FedAvg simulator over a device-resident population.

    ``data`` is the dict from ``FederatedDataset.to_device_arrays()``. The
    availability / Pace-Steering parameters mirror ``PopulationSim``; pass
    ``weight_fn(last_round, synthetic, round_idx) -> (N,) weights`` to
    replace the Pace-Steering prior.

    ``sampling`` defaults to ``dp.sampling``: ``"fixed"`` rounds of exactly
    qN devices (Algorithm 1), or ``"poisson"`` variable-size rounds (each
    available device i.i.d. Bernoulli(qN/N); Pace-Steering weights don't
    apply).

    ``cohort_chunk`` streams the round ``cohort_chunk`` clients at a time
    (it must divide the block size, padded cohort / 8); ``None``
    auto-selects; ``0`` is the materializing path. ``clip_path`` selects
    the clip→accumulate: ``"fused"`` (the CUDA dp_clip kernels) or
    ``"tree"`` (plain tensor ops).

    ``device`` (default ``cuda``; raises without a GPU) holds the corpus,
    the population vectors and the generator."""

    def __init__(self, model: Model, data, dp: DPConfig,
                 client: ClientConfig, *,
                 n_local_batches: int = 4, availability: float = 0.1,
                 pace_cooldown: int = 50, pace_penalty: float = 0.01,
                 rounds_per_call: int = 8,
                 weight_fn: Optional[Callable] = None,
                 sampling: Optional[str] = None,
                 poisson_buffer: Optional[int] = None,
                 num_shards: int = 1, num_pods: int = 1,
                 cohort_chunk: Optional[int] = None,
                 clip_path: str = "fused",
                 population_backend: str = "device",
                 sampler: str = "global",
                 fault_config=None,
                 eval_fn: Optional[Callable] = None, eval_every: int = 1,
                 device=None):
        if num_shards != 1 or num_pods != 1:
            raise NotImplementedError(
                f"num_shards={num_shards}, num_pods={num_pods}: cohort "
                "sharding over devices is not ported yet (ROADMAP.md, queue "
                "A, item 5); the port's engine runs on one device")
        if population_backend not in POPULATION_BACKENDS:
            raise ValueError(f"population_backend must be one of "
                             f"{POPULATION_BACKENDS}, got "
                             f"{population_backend!r}")
        if population_backend != "device":
            raise NotImplementedError(
                "population_backend='streamed' is not ported yet (ROADMAP.md,"
                " queue A, item 5); the port keeps the corpus on the device")
        if sampler not in SAMPLERS:
            raise ValueError(f"sampler must be one of {SAMPLERS}, "
                             f"got {sampler!r}")
        if sampler != "global":
            raise NotImplementedError(
                "sampler='sharded' is not ported yet (ROADMAP.md, queue A, "
                "item 5); the port samples with the global sampler")
        if clip_path not in CLIP_PATHS:
            raise ValueError(f"clip_path must be one of {CLIP_PATHS}, "
                             f"got {clip_path!r}")
        self.device = resolve_device(device)
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
        self.examples = torch.as_tensor(np.asarray(data["examples"]),
                                        dtype=torch.int32).to(self.device)
        self.counts = torch.as_tensor(np.asarray(data["counts"]),
                                      dtype=torch.int32).to(self.device)
        synth_np = np.asarray(data["synthetic"], bool)
        self.synthetic = torch.from_numpy(synth_np).to(self.device)
        self.n_users = int(synth_np.shape[0])
        self.cohort = min(dp.clients_per_round, self.n_users)
        self.q = self.cohort / self.n_users
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
            self.buffer = canon_pad(min(self.n_users, buf))
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
            self.padded = canon_pad(self.sel_cohort)
        self.cohort_chunk = resolve_chunk(cohort_chunk,
                                          self.padded // CANON_BLOCKS)
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
        self._fixed_live = self._live(self._fixed_host)

    def _live(self, host_mask: torch.Tensor):
        """Which chunks of the streaming sum hold an unmasked slot, from a
        mask on the host (None on the materializing path)."""
        if self.cohort_chunk == 0:
            return None
        return host_mask.reshape(self._shape3()).any(-1).tolist()

    def _shape3(self) -> Tuple[int, int, int]:
        chunk = self.cohort_chunk
        return (CANON_BLOCKS, self.padded // (CANON_BLOCKS * chunk), chunk)

    # ------------------------------------------------------------------ state

    def init_state(self, params, seed: int = 0,
                   opt_state: Optional[ServerOptState] = None,
                   draws=None) -> EngineState:
        """Initial state: ``params`` on the engine's device, a fresh
        optimizer state (or ``opt_state``), and ``draws`` — by default an
        :class:`EngineDraws` over a generator on the device seeded with
        ``seed``."""
        params = tree_map(lambda l: l.detach().to(self.device),
                          strip_compute(params))
        if draws is None:
            draws = EngineDraws(torch.Generator(device=self.device)
                                .manual_seed(seed))
        n = self.n_users
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

    # ------------------------------------------------------------- round body

    def _sample_phase(self, state: EngineState):
        """Availability, cohort selection, the fault fates and the
        population vectors' update, then the per-slot example indices.
        Returns ``(last_round, participation, ids, slot_mask, report_mask,
        corrupt, idx, live)``: without faults ``report_mask`` is
        ``slot_mask`` and ``corrupt`` None; ``live`` is the host list of
        live chunks (fixed rounds) or None (read from the mask)."""
        d, r = state.draws, state.round_idx
        d.begin_round(r)
        avail = (d.available(self.n_users).to(self.device)
                 < self.availability) | self.synthetic
        if self.sampling == "poisson":
            ids, slot_mask, took = d.poisson(self.sel_q, avail, self.padded)
            ids, slot_mask = ids.to(self.device), slot_mask.to(self.device)
            took = took.to(self.device)
            live = None
        else:
            w = self.weight_fn(state.last_round, self.synthetic, r)
            ids = d.cohort(w, avail, self.sel_cohort).to(self.device)
            ids = torch.nn.functional.pad(ids,
                                          (0, self.padded - self.sel_cohort))
            slot_mask = self._fixed_mask
            live = self._fixed_live
        if self.faults is None:
            report_mask, corrupt = slot_mask, None
        else:
            # slot-level fates from the fault stream, on the host: a fixed
            # round's live chunks follow from them without a device read
            fates = d.fates(r, self.padded, self.faults)
            reported = fates.reported.cpu()
            report_mask = slot_mask & reported.to(self.device)
            corrupt = report_mask & fates.corrupt.to(self.device)
            if live is not None:
                live = self._live(self._fixed_host & reported)
        if self.sampling == "poisson":
            last_round = torch.where(took, r, state.last_round).to(torch.int32)
            if self.faults is None:
                participation = state.participation + took.to(torch.int32)
            else:
                participation = state.participation.index_add(
                    0, ids, report_mask.to(torch.int32))
        else:
            # padded slots alias device 0: scatter through the mask so they
            # never touch the population vectors
            last_round = state.last_round.scatter_reduce(
                0, ids, torch.where(slot_mask, r, _NEVER).to(torch.int32),
                reduce="amax")
            participation = state.participation.index_add(
                0, ids, report_mask.to(torch.int32))
        need = self.n_local_batches * self.client.batch_size
        idx = d.example_indices(self.counts[ids], need).to(self.device)
        return (last_round, participation, ids, slot_mask, report_mask,
                corrupt, idx, live)

    def _cohort_sums(self, params, ids, idx, mask, live, corrupt=None):
        """The masked clipped sum over the padded cohort and its stats
        (mean norm, clipped fraction, mean loss over the unmasked slots).
        ``corrupt`` (fault model) marks the slots whose reports are
        non-finite garbage: their deltas and losses are multiplied by NaN
        (clean slots by 1, which changes no bit) and the fold rejects them
        (``guard_nonfinite``). Returns the folded sum, the three stats and
        the count of accepted slots (a device scalar)."""
        nb, B = self.n_local_batches, self.client.batch_size
        if self.cohort_chunk == 0:
            batches = gather_client_batches(self.examples, ids, idx, nb, B)
            return round_compute(self.model, params, batches, self.client,
                                 self.dp, mask, cohort_chunk=0) + (
                                     mask.to(torch.float32).sum(),)
        shape3 = self._shape3()
        inputs = {"ids": ids.reshape(shape3),
                  "idx": idx.reshape(shape3 + (idx.shape[-1],))}
        if corrupt is not None:
            inputs["bad"] = corrupt.to(torch.float32).reshape(shape3)

        def compute_chunk(inp):
            batches = gather_client_batches(self.examples, inp["ids"],
                                            inp["idx"], nb, B)
            deltas, losses = local_deltas(self.model, params, batches,
                                          self.client)
            if corrupt is None:
                return deltas, losses
            poison = torch.where(inp["bad"] > 0, float("nan"), 1.0)
            deltas = [tree_map(lambda l, p=p: l * p, d)
                      for d, p in zip(deltas, poison)]
            return deltas, losses * poison

        partials, stats = stream_block_sums(
            compute_chunk, inputs, mask.to(torch.float32).reshape(shape3),
            params, self.dp.clip_norm, clip_path=self.clip_path,
            guard_nonfinite=corrupt is not None, live=live)
        return fold_round(partials, stats)

    def _round(self, state: EngineState) -> Tuple[EngineState, Dict]:
        r = state.round_idx
        (last_round, participation, ids, slot_mask, report_mask, corrupt,
         idx, live) = self._sample_phase(state)
        total, mean_norm, frac, loss, accepted = self._cohort_sums(
            state.params, ids, idx, report_mask, live, corrupt)
        std = self.dp.noise_multiplier * self.dp.clip_norm \
            / float(self._round_denom)
        # the noise is drawn whether or not the round commits, so that no
        # later draw depends on the verdict
        delta, _ = finalize_round(total, self._round_denom, None, self.dp,
                                  stats=(mean_norm, frac),
                                  noise=state.draws.noise(total, std))
        params, opt_state = server_step(state.params, state.opt_state, delta,
                                        self.dp)
        n_selected = slot_mask.sum().to(torch.int32)
        rec = {"loss": loss, "mean_update_norm": mean_norm,
               "frac_clipped": frac, "noise_std": std,
               "n_clients": n_selected}
        if self.faults is not None:
            # commit iff the accepted reports reach the goal, decided on
            # the device: an aborted round keeps every old leaf's bits
            committed = accepted >= float(self.report_goal)
            params, opt_state = _select(committed, (params, opt_state),
                                        (state.params, state.opt_state))
            rec.update(n_clients=accepted.to(torch.int32),
                       n_selected=n_selected,
                       n_reported=report_mask.sum().to(torch.int32),
                       committed=committed)
        if self.eval_fn is not None:
            rec["eval_mask"] = (r + 1) % self.eval_every == 0
            if rec["eval_mask"]:
                with torch.no_grad():
                    rec["eval"] = self.eval_fn(params, r)
        return EngineState(params, opt_state, state.draws, last_round,
                           participation, r + 1), rec

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
