"""Federated Secret Sharer — the paper's §II-B / §IV measurement framework
(the reference's ``core/secret_sharer.py``).

Canaries are 5-word sequences with each word drawn u.a.r. from the model
vocabulary, parameterized by (n_u = #secret-sharing users, n_e = #copies per
user). Two extraction measures:

* Random Sampling (RS) rank [CLK+18]: rank of the canary continuation's
  log-perplexity P_θ(s|p) among |R| random continuations (paper: |R|=2e6).
* Beam Search (BS): is the canary among the top-5 width-5 continuations of
  its 2-word prefix.

Scoring runs through the model's ``forward`` (on the card, the CIFG
sequence kernel, one launch per forward). Random draws — the canaries and
the RS continuation pool — come from an explicit ``torch.Generator``; the
port cannot reproduce the reference's JAX draws, so a caller that needs the
reference's canaries passes them in as data, and ``random_sampling_ranks``
takes a given pool through ``continuations``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.api import Model
from repro_torch.utils.pytree import tree_leaves
from repro_torch.utils.spans import count, span

CANARY_LEN = 5
PREFIX_LEN = 2


@dataclass(frozen=True)
class Canary:
    tokens: Tuple[int, ...]   # full 5-word canary (token ids)
    n_u: int                  # users sharing this canary
    n_e: int                  # copies per user

    @property
    def prefix(self) -> Tuple[int, ...]:
        return self.tokens[:PREFIX_LEN]

    @property
    def continuation(self) -> Tuple[int, ...]:
        return self.tokens[PREFIX_LEN:]


def make_canaries(generator: torch.Generator, vocab: int,
                  grid: Sequence[Tuple[int, int]] = ((1, 1), (1, 14), (1, 200),
                                                     (4, 1), (4, 14), (4, 200),
                                                     (16, 1), (16, 14), (16, 200)),
                  per_config: int = 3, length: int = CANARY_LEN) -> List[Canary]:
    """``per_config`` canaries for each (n_u, n_e) configuration in ``grid``
    (the paper's §IV-A setup is the default: 3 canaries × 9 configs = 27),
    every word drawn from ``generator``.

    Canaries whose ``PREFIX_LEN``-word prefix collides with an earlier
    canary's are redrawn: beam-search extraction conditions on the prefix, so
    two canaries sharing one would compete for the same beam and the
    per-canary extracted/not-extracted verdict would be ill-defined.
    """
    total = len(grid) * per_config
    space = vocab ** PREFIX_LEN
    if total > space:
        raise ValueError(
            f"cannot draw {total} canaries with distinct {PREFIX_LEN}-word "
            f"prefixes from a {vocab}-word vocabulary ({space} prefixes)")
    canaries = []
    seen = set()
    for (n_u, n_e) in grid:
        for _ in range(per_config):
            for _attempt in range(10_000):
                toks = tuple(torch.randint(
                    0, vocab, (length,), generator=generator,
                    device=generator.device).tolist())
                if toks[:PREFIX_LEN] not in seen:
                    break
            else:
                raise RuntimeError("make_canaries: could not draw a "
                                   "collision-free prefix in 10k attempts")
            seen.add(toks[:PREFIX_LEN])
            canaries.append(Canary(toks, n_u, n_e))
    return canaries


def canary_matrix(canaries: Sequence[Canary]) -> np.ndarray:
    """Stack canary token sequences into a (K, CANARY_LEN) int32 matrix —
    the batched-scoring layout used by :func:`score_canaries`."""
    return np.asarray([c.tokens for c in canaries], np.int32)


def _device(params) -> torch.device:
    return tree_leaves(params)[0].device


# ---------------------------------------------------------------------------
# log-perplexity scoring
# ---------------------------------------------------------------------------


def _batched_log_perplexity(params, seqs: torch.Tensor, model: Model,
                            prefix_len: int) -> torch.Tensor:
    """seqs: (B, L) full sequences (prefix + continuation).
    Returns (B,) Σ_i −log Pr(s_i | p, s_<i) over the continuation positions:
    the log-softmax over the whole padded vocab at each position that
    predicts a continuation word, taken as logit − logsumexp."""
    with torch.no_grad():
        logits = model.forward(params, {"tokens": seqs})     # (B, L, Vpad)
        # next-token prediction: logits at position i predict token i+1
        pred = logits[:, prefix_len - 1:-1].float()
        targets = seqs[:, prefix_len:].long()
        lp = (pred.gather(-1, targets[..., None])[..., 0]
              - torch.logsumexp(pred, dim=-1))               # (B, L-p)
        return -lp.sum(dim=-1)


def score_canaries(model: Model, params, canary_tokens,
                   prefix_len: int = PREFIX_LEN) -> torch.Tensor:
    """Batched canary log-perplexity: (K, L) token batch → (K,) float32
    Σ −log Pr(continuation | prefix), on the parameters' device, with no
    host read — the body of the in-engine eval hook and the chunk scorer of
    :func:`random_sampling_ranks`."""
    seqs = torch.as_tensor(canary_tokens, device=_device(params))
    return _batched_log_perplexity(params, seqs, model, prefix_len)


def canary_eval_fn(model: Model, canaries: Sequence[Canary]):
    """Build a ``SimEngine`` eval hook scoring all ``canaries`` each call:
    ``eval_fn(params, round_idx) -> {"canary_logppl": (K,) f32}``."""
    toks = torch.from_numpy(canary_matrix(canaries))
    on = {}

    def eval_fn(params, round_idx):
        dev = _device(params)
        if dev not in on:
            on[dev] = toks.to(dev)
        return {"canary_logppl": score_canaries(model, params, on[dev])}

    return eval_fn


def log_perplexity(model: Model, params, sequences: np.ndarray,
                   prefix_len: int = PREFIX_LEN, batch_size: int = 512) -> np.ndarray:
    """Score many (prefix+continuation) sequences; returns np.float32 (N,)."""
    out = []
    for i in range(0, sequences.shape[0], batch_size):
        out.append(score_canaries(model, params, sequences[i:i + batch_size],
                                  prefix_len).cpu().numpy())
    return np.concatenate(out).astype(np.float32)


def random_sampling_ranks(model: Model, params, canaries: Sequence[Canary],
                          generator: Optional[torch.Generator] = None,
                          n_samples: int = 100_000, batch_size: int = 1024,
                          continuations=None) -> np.ndarray:
    """rank_θ(c; R) = |{r ∈ R : P_θ(r|p) < P_θ(s|p)}| for *all* canaries at
    once (paper §IV-A.1). One shared pool of |R| random continuations is
    scored behind every canary's prefix in (K·batch_size)-sequence chunks,
    one forward per chunk; the ranks stay on the device until the end.

    The pool is drawn chunk by chunk from ``generator`` (on its device), or
    is ``continuations`` ((|R|, CANARY_LEN − PREFIX_LEN) ints) when given,
    in which case ``n_samples`` is its length. Returns int64 (K,) ranks."""
    K = len(canaries)
    vocab = model.cfg.vocab
    cont_len = CANARY_LEN - PREFIX_LEN
    dev = _device(params)
    with span("rs.pass"):
        toks = torch.from_numpy(canary_matrix(canaries)).to(dev)
        prefixes = toks[:, :PREFIX_LEN]
        with span("rs.canaries"):
            canary_scores = score_canaries(model, params, toks)
        pool = None
        if continuations is not None:
            pool = torch.as_tensor(continuations).to(dev)
            if pool.dim() != 2 or pool.shape[1] != cont_len:
                raise ValueError(f"continuations must be (|R|, {cont_len}), "
                                 f"got {tuple(pool.shape)}")
            n_samples = pool.shape[0]
        elif generator is None:
            raise ValueError("random_sampling_ranks needs a generator or a "
                             "continuations pool")
        ranks = torch.zeros((K,), dtype=torch.int64, device=dev)
        for i in range(0, n_samples, batch_size):
            with span("rs.chunk", chunk=i // batch_size):
                b = min(batch_size, n_samples - i)
                if pool is not None:
                    conts = pool[i:i + b]
                else:
                    conts = torch.randint(0, vocab, (b, cont_len),
                                          generator=generator,
                                          device=generator.device).to(dev)
                seqs = torch.cat(
                    [prefixes[:, None].expand(K, b, PREFIX_LEN),
                     conts[None].expand(K, b, cont_len).to(toks.dtype)],
                    dim=-1).reshape(K * b, CANARY_LEN)
                scores = score_canaries(model, params, seqs).reshape(K, b)
                ranks += (scores < canary_scores[:, None]).sum(dim=1)
        with span("rs.read"):
            count("host_reads")
            return ranks.cpu().numpy()


def random_sampling_rank(model: Model, params, canary: Canary,
                         generator: Optional[torch.Generator] = None,
                         n_samples: int = 100_000, batch_size: int = 1024,
                         continuations=None) -> int:
    """Single-canary convenience wrapper over :func:`random_sampling_ranks`."""
    return int(random_sampling_ranks(model, params, [canary], generator,
                                     n_samples, batch_size, continuations)[0])


# ---------------------------------------------------------------------------
# beam search extraction
# ---------------------------------------------------------------------------


def beam_search(model: Model, params, prefix: Sequence[int], total_len: int,
                width: int = 5) -> List[Tuple[int, ...]]:
    """Greedy beam search continuation of ``prefix`` to ``total_len`` words.
    Returns the top-``width`` sequences (paper §IV-A.2). One forward of the
    live beams per step; candidates are chosen on the host as the
    reference chooses them."""
    vocab = model.cfg.vocab
    dev = _device(params)
    beams = [(tuple(prefix), 0.0)]
    for _ in range(total_len - len(prefix)):
        seqs = torch.tensor([b[0] for b in beams], dtype=torch.int32,
                            device=dev)
        with torch.no_grad():
            logits = model.forward(params, {"tokens": seqs})[:, -1, :]
            logp = torch.log_softmax(logits.float(), dim=-1)[:, :vocab]
        logp = logp.cpu().numpy()
        cand = []
        for (toks, score), row in zip(beams, logp):
            top = np.argpartition(-row, width)[:width]
            for t in top:
                cand.append((toks + (int(t),), score + float(row[t])))
        cand.sort(key=lambda x: -x[1])
        beams = cand[:width]
    return [b[0] for b in beams]


def canary_extracted(model: Model, params, canary: Canary,
                     width: int = 5) -> bool:
    """BS check: canary among top-5 5-word continuations of its 2-word prefix."""
    tops = beam_search(model, params, canary.prefix, CANARY_LEN, width)
    return tuple(canary.tokens) in [tuple(t) for t in tops]
