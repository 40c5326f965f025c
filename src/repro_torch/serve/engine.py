"""Continuous-batching NWP serving engine with a session cache on the device.

The port of ``repro.serve.engine``:

* **Fixed-slot session cache** — the decode state of up to ``max_slots``
  concurrent sessions lives on the device, one row per session in every
  cache leaf (for the CIFG-LSTM the ``(h, c)`` pair plus a position).
  Admission writes a freshly prefilled session into a free slot, in place;
  completion or timeout frees it.
* **Continuous batching** — every tick runs ONE ``decode_step`` over the
  whole slot axis; sessions at different depths share the batch, and
  finished sessions hand their slot to queued ones between ticks (FIFO).
* **Per-session sampling** — token *t* of a session depends only on its key,
  *t*, its temperature and the logits (`repro_torch.serve.sampling`), so the
  engine matches the single-session reference (`repro_torch.serve.reference`)
  token for token.
* **Top-k candidates** for the suggestion strip at each emitted position.
* **Bucketed admission** — prompts are right-padded to a power of two and
  the model's length-aware prefill gathers the state at the true length. A
  probe at construction checks that this is bitwise the exact-length
  prefill; a model that fails it is admitted at exact length.
* **Atomic hot-swap** — :meth:`swap_params` / :meth:`load_checkpoint` promote
  new weights between ticks. A tick reads one parameter set, so no session
  computes a step from two checkpoints; each token records its params
  version. The compute-dtype copies of the new weights are made once, here.

The port runs eagerly: ``jax.jit`` has no counterpart here.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.serve import sampling
from repro_torch.serve.frontend import (NwpRequest, RequestQueue,
                                        SessionResult, _Session,
                                        make_session_key, new_session_id)
from repro_torch.train import checkpoint as checkpoint_lib
from repro_torch.utils.params import (from_jax_params, param_device,
                                      with_compute_copies)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    else:
        yield path, tree


def validate_cache_layout(model: Model, max_slots: int, max_len: int, *,
                          device=None):
    """Build the slot cache and enforce the per-row serving contract.
    Returns the (zero-initialised) cache on success."""
    cache = model.init_cache(max_slots, max_len, device=device)
    bad = [(path, tuple(leaf.shape)) for path, leaf in _leaves(cache)
           if leaf.dim() < 1 or leaf.shape[0] != max_slots]
    if bad:
        detail = ", ".join(f"{p}: shape {s}" for p, s in bad)
        raise ValueError(
            f"model '{model.cfg.name}' is not continuous-batching capable: "
            f"the serving engine scatters per-session state by slot, so "
            f"every decode-cache leaf must be per-row (leading dim = "
            f"max_slots={max_slots}); offending leaves: {detail}. "
            f"Recurrent-state models (the paper's CIFG-LSTM) satisfy this; "
            f"shared ring-buffer KV caches do not (yet).")
    return cache


class ServeEngine:
    """Session-oriented continuous-batching decode loop over
    ``model.decode_step``, on the device of ``params``.

    Single-threaded host driver: :meth:`submit` enqueues sessions,
    :meth:`step` runs one admission + decode tick (:meth:`run` drains),
    :meth:`result` returns a finished session. Not thread-safe —
    callers interleave submits and swaps between ticks, which is what makes
    the hot-swap atomic."""

    def __init__(self, model: Model, params, *, max_slots: int = 256,
                 top_k: int = 3, max_len: int = 64,
                 default_ttl_ticks: Optional[int] = None):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if top_k < 1 or top_k > model.cfg.vocab:
            raise ValueError(f"top_k must be in [1, vocab="
                             f"{model.cfg.vocab}], got {top_k}")
        self.model = model
        self.max_slots = max_slots
        self.top_k = top_k
        self.vocab = model.cfg.vocab
        self.default_ttl_ticks = default_ttl_ticks

        self._params = with_compute_copies(params, model.cfg.compute_dtype,
                                           model.compute_copies)
        self._device = param_device(self._params)
        self._params_version = 0

        self._cache = validate_cache_layout(model, max_slots, max_len,
                                            device=self._device)
        # host-side per-slot control state, shipped to the device every tick
        self._slots: List[Optional[_Session]] = [None] * max_slots
        self._cur_tok = np.zeros((max_slots,), np.int64)
        self._keys = np.zeros((max_slots, 2), np.int64)
        self._ts = np.zeros((max_slots,), np.int64)
        self._temps = np.zeros((max_slots,), np.float32)

        self._queue = RequestQueue()
        self._results: Dict[str, SessionResult] = {}
        self._session_ids = set()   # every id submitted: queued, live, done
        self._ticks = 0          # step() calls (admission opportunities)
        self._decode_ticks = 0   # ticks that ran a decode batch
        # wall-clock seconds per admission (prefill + first-token sample,
        # synced on the emitted token)
        self._admission_times: List[float] = []
        self._bucketed = self._probe_length_support()

    # ------------------------------------------------------------- frontend

    @property
    def params_version(self) -> int:
        return self._params_version

    @property
    def in_flight(self) -> int:
        """Sessions admitted to a slot or waiting in the queue."""
        return len(self._queue) + self.active_sessions

    @property
    def active_sessions(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def ticks(self) -> int:
        return self._ticks

    @property
    def decode_ticks(self) -> int:
        return self._decode_ticks

    def submit(self, request: NwpRequest) -> str:
        """Validate and enqueue a session; returns its id. A ``steps=0``
        request completes at once with exactly the prompt."""
        request.validate(self.vocab, self.top_k)
        sid = request.session_id or new_session_id()
        if sid in self._session_ids:
            raise ValueError(f"duplicate session_id {sid!r}")
        self._session_ids.add(sid)
        sess = _Session(request=request, session_id=sid,
                        key=make_session_key(request.seed),
                        submit_tick=self._ticks,
                        submit_time=time.perf_counter())
        if request.steps == 0:
            sess.admit_tick = self._ticks
            self._finalize(sess, "done", slot=None)
            return sid
        self._queue.push(sess)
        return sid

    def result(self, session_id: str) -> SessionResult:
        return self._results[session_id]

    # ------------------------------------------------------------- hot swap

    def swap_params(self, new_params) -> int:
        """Promote ``new_params`` for every later prefill and decode tick.
        In-flight sessions keep their slots and state; emitted tokens keep
        their version. Returns the new params version."""
        new = with_compute_copies(new_params, self.model.cfg.compute_dtype,
                                  self.model.compute_copies)
        if param_device(new) != self._device:
            raise ValueError(f"new params are on {param_device(new)}, the "
                             f"engine serves on {self._device}")
        shapes = {p: tuple(t.shape) for p, t in _leaves(self._params)}
        bad = [(p, shapes.get(p), tuple(t.shape)) for p, t in _leaves(new)
               if shapes.get(p) != tuple(t.shape)]
        if bad:
            raise ValueError(f"new params do not fit the served model "
                             f"(leaf, served shape, new shape): {bad}")
        self._params = new
        self._params_version += 1
        return self._params_version

    def load_checkpoint(self, path) -> int:
        """Hot-swap from a checkpoint file of the reference's format: read
        and put on the device first, then published in one
        :meth:`swap_params` call."""
        tree, _meta = checkpoint_lib.load(path)
        return self.swap_params(from_jax_params(
            tree, self.model.compute_copies, device=self._device,
            compute_dtype=self.model.cfg.compute_dtype))

    # ------------------------------------------------------------- the loop

    def step(self) -> bool:
        """One tick: admit from the queue into free slots, then run one
        batched decode step over all slots. Returns True while work is in
        flight."""
        self._ticks += 1
        for slot in range(self.max_slots):
            if not len(self._queue):
                break
            if self._slots[slot] is None:
                self._admit(slot, self._queue.pop())
        if self.active_sessions == 0:
            return len(self._queue) > 0
        self._decode_ticks += 1
        dev = self._device
        logits, self._cache = self.model.decode_step(
            self._params, torch.tensor(self._cur_tok, device=dev),
            self._cache)
        lg = logits[:, :self.vocab]
        nxt = sampling.sample_tokens(
            lg, torch.tensor(self._keys, device=dev),
            torch.tensor(self._ts, device=dev),
            torch.tensor(self._temps, device=dev))
        out = torch.cat([nxt[:, None], sampling.topk_ids(lg, self.top_k)],
                        dim=1).cpu().numpy()
        for slot, sess in enumerate(self._slots):
            if sess is None:
                continue
            self._record_token(sess, int(out[slot, 0]), out[slot, 1:])
            self._cur_tok[slot] = out[slot, 0]
            self._ts[slot] += 1
            sess.ticks_in_slot += 1
            if len(sess.tokens) >= sess.request.steps:
                self._finalize(sess, "done", slot=slot)
            elif self._ttl(sess) and sess.ticks_in_slot >= self._ttl(sess):
                self._finalize(sess, "evicted", slot=slot)
        return self.in_flight > 0

    def run(self, max_ticks: int = 100_000) -> Dict[str, SessionResult]:
        """Drain queue and slots; returns {session_id: result} for every
        session finished during this call."""
        before = dict(self._results)
        for _ in range(max_ticks):
            if not self.step():
                break
        else:
            raise RuntimeError(f"run() did not drain in {max_ticks} ticks")
        return {k: v for k, v in self._results.items() if k not in before}

    # ------------------------------------------------------------ internals

    def _ttl(self, sess: _Session) -> Optional[int]:
        ttl = sess.request.ttl_ticks
        return ttl if ttl is not None else self.default_ttl_ticks

    def _prefill(self, tokens: np.ndarray, length: Optional[int] = None):
        batch = {"tokens": torch.tensor(tokens, device=self._device)}
        if length is not None:
            batch["length"] = np.array([length], np.int64)
        last, sub = self.model.prefill(self._params, batch)
        return last[:, :self.vocab], sub

    def _probe_length_support(self) -> bool:
        """A model supports bucket-padded admission iff prefilling ``[t]``
        unpadded and ``[t, 0]`` with ``length=[1]`` agree bitwise (logits
        and every cache leaf). A model that rejects — or ignores — the
        ``"length"`` key fails the probe and is admitted at exact length."""
        try:
            ref_lg, ref_sub = self._prefill(np.zeros((1, 1), np.int64))
            lg, sub = self._prefill(np.zeros((1, 2), np.int64), length=1)
        except (ValueError, TypeError, KeyError, IndexError):
            return False
        ref_leaves = [ref_lg] + [v for _, v in _leaves(ref_sub)]
        leaves = [lg] + [v for _, v in _leaves(sub)]
        return len(ref_leaves) == len(leaves) and all(
            a.shape == b.shape and bool(torch.equal(a, b))
            for a, b in zip(ref_leaves, leaves))

    @property
    def admission_times_s(self) -> tuple:
        """Wall-clock seconds per admission (prefill + first-token sample,
        synced on the emitted token), in admission order."""
        return tuple(self._admission_times)

    @property
    def bucketed_admission(self) -> bool:
        """True when the construction-time probe validated the model's
        length-aware prefill and admissions pad to power-of-two buckets."""
        return self._bucketed

    def _admit(self, slot: int, sess: _Session) -> None:
        """Prefill the prompt (current params), write the session state into
        ``slot`` and emit token 0 from the prefill logits."""
        t0 = time.perf_counter()
        raw = np.asarray(sess.request.prompt, np.int64)
        L = int(raw.shape[0])
        if self._bucketed and L > 1:
            padded = np.zeros((1, 1 << (L - 1).bit_length()), np.int64)
            padded[0, :L] = raw
            lg, sub = self._prefill(padded, length=L)
        else:
            lg, sub = self._prefill(raw[None, :])
        dev = self._device
        tok0 = sampling.sample_tokens(
            lg, torch.tensor(sess.key[None].astype(np.int64), device=dev),
            torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.full((1,), sess.request.temperature, dtype=torch.float32,
                       device=dev))
        out = torch.cat([tok0[:, None], sampling.topk_ids(lg, self.top_k)],
                        dim=1)[0].cpu().numpy()
        for name, buf in self._cache.items():
            buf[slot] = sub[name][0]
        sess.admit_tick = self._ticks
        self._slots[slot] = sess
        self._keys[slot] = sess.key
        self._temps[slot] = sess.request.temperature
        self._record_token(sess, int(out[0]), out[1:])
        self._admission_times.append(time.perf_counter() - t0)
        self._cur_tok[slot] = sess.tokens[-1]
        self._ts[slot] = 1
        if len(sess.tokens) >= sess.request.steps:
            self._finalize(sess, "done", slot=slot)

    def _record_token(self, sess: _Session, tok: int, cands) -> None:
        sess.tokens.append(tok)
        sess.candidates.append(np.asarray(cands, np.int32))
        sess.versions.append(self._params_version)

    def _finalize(self, sess: _Session, status: str,
                  slot: Optional[int]) -> None:
        if slot is not None:
            self._slots[slot] = None
            self._temps[slot] = 0.0
            self._ts[slot] = 0
        k = sess.request.top_k or self.top_k
        cands = (np.stack(sess.candidates)[:, :k] if sess.candidates
                 else np.zeros((0, k), np.int32))
        res = SessionResult(
            session_id=sess.session_id,
            prompt=tuple(int(t) for t in sess.request.prompt),
            tokens=tuple(sess.tokens),
            candidates=cands,
            status=status,
            params_versions=tuple(sess.versions),
            submit_tick=sess.submit_tick,
            admit_tick=sess.admit_tick,
            finish_tick=self._ticks,
            latency_s=time.perf_counter() - sess.submit_time)
        self._results[sess.session_id] = res
