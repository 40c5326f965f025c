"""Serving frontend types: session requests, results, and the FIFO queue.

A *session* is one suggestion-strip interaction: the client ships a prompt,
the engine admits it into a decode slot, emits ``steps`` next-word
predictions (each with ``top_k`` ranked candidates), and the session
completes. Requests that cannot be admitted at once wait in the
:class:`RequestQueue`.

Sampling is per-session deterministic: a session's tokens depend only on
(params, prompt, seed, temperature), never on its slot, on what else shared
the batch, or on when it was admitted.
"""
from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Deque, Optional, Tuple

import numpy as np

_SESSION_COUNTER = itertools.count()


@dataclass(frozen=True)
class NwpRequest:
    """One next-word-prediction session request.

    ``seed`` keys the session's sampling stream (required when
    ``temperature > 0``); ``ttl_ticks`` bounds how many decode ticks the
    session may hold a slot before the engine evicts it (``None`` = engine
    default)."""
    prompt: Tuple[int, ...]
    steps: int
    session_id: Optional[str] = None
    temperature: float = 0.0
    seed: Optional[int] = None
    top_k: Optional[int] = None
    ttl_ticks: Optional[int] = None

    def validate(self, vocab: int, engine_top_k: int) -> None:
        if self.steps < 0:
            raise ValueError(f"steps must be >= 0, got {self.steps}")
        if len(self.prompt) == 0:
            raise ValueError("prompt must be non-empty (at least BOS)")
        toks = np.asarray(self.prompt)
        if toks.min() < 0 or toks.max() >= vocab:
            raise ValueError(
                f"prompt tokens must be in [0, {vocab}), got range "
                f"[{toks.min()}, {toks.max()}]")
        if self.temperature > 0.0 and self.seed is None:
            raise ValueError(
                "temperature>0 sampling needs a per-session seed: pass "
                "NwpRequest(seed=...) so concurrent sessions draw from "
                "independent, reproducible streams")
        if self.top_k is not None and not (1 <= self.top_k <= engine_top_k):
            raise ValueError(
                f"top_k must be in [1, {engine_top_k}] (the engine's "
                f"candidate width), got {self.top_k}")
        if self.ttl_ticks is not None and self.ttl_ticks < 1:
            raise ValueError(f"ttl_ticks must be >= 1, got {self.ttl_ticks}")


@dataclass
class SessionResult:
    """Completed (or evicted) session: the emitted tokens, the per-position
    top-k candidate strip, and the params version that produced each token
    (how the hot-swap drill shows no step mixed two checkpoints)."""
    session_id: str
    prompt: Tuple[int, ...]
    tokens: Tuple[int, ...]
    candidates: np.ndarray            # (len(tokens), top_k) int32, ranked
    status: str                       # "done" | "evicted"
    params_versions: Tuple[int, ...]  # one entry per emitted token
    submit_tick: int
    admit_tick: int
    finish_tick: int
    latency_s: float

    @property
    def sequence(self) -> Tuple[int, ...]:
        return self.prompt + self.tokens


@dataclass
class _Session:
    """Engine-internal per-session bookkeeping (host side)."""
    request: NwpRequest
    session_id: str
    key: np.ndarray                   # (2,) uint32 — session sampling key
    submit_tick: int
    submit_time: float
    tokens: list = field(default_factory=list)
    candidates: list = field(default_factory=list)
    versions: list = field(default_factory=list)
    admit_tick: int = -1
    ticks_in_slot: int = 0


class RequestQueue:
    """FIFO admission queue; the engine pops in arrival order."""

    def __init__(self):
        self._q: Deque = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def push(self, item) -> None:
        self._q.append(item)

    def pop(self):
        return self._q.popleft()


def new_session_id() -> str:
    return f"s{next(_SESSION_COUNTER):08d}"


def make_session_key(seed: Optional[int]) -> np.ndarray:
    """A session's (2,) uint32 key: the high and low 32-bit words of the
    seed — the words of the reference's ``PRNGKey(seed)`` for
    0 <= seed < 2**32 — or zeros for a greedy session with no seed."""
    if seed is None:
        return np.zeros((2,), np.uint32)
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)
