"""The Secret Sharer's traffic (paper §IV-A): canaries of ``canary_len``
words drawn uniformly from the vocabulary with pairwise-distinct
``prefix_len``-word prefixes, and one Random-Sampling pool a pass, |R|
continuations of ``canary_len − prefix_len`` words drawn uniformly.

Mix keys: ``kind`` ``rs_sweep``, ``n_canaries``, ``canary_len``,
``prefix_len``, ``pool`` (|R|), ``chunk`` (continuations a chunk, each
scored behind every canary).
"""
from __future__ import annotations

import torch


def canaries(mix: dict, vocab: int, g: torch.Generator) -> torch.Tensor:
    """(K, canary_len) int64 canary tokens on the generator's device; a
    candidate whose prefix repeats an earlier one is dropped."""
    K, L, P = mix["n_canaries"], mix["canary_len"], mix["prefix_len"]
    cand = torch.randint(0, vocab, (4 * K, L), generator=g, device=g.device)
    seen, keep = set(), []
    for i, row in enumerate(cand[:, :P].tolist()):
        if tuple(row) not in seen:
            seen.add(tuple(row))
            keep.append(i)
    if len(keep) < K:
        raise RuntimeError("too few canaries with distinct prefixes")
    return cand[keep[:K]]


def pool(mix: dict, vocab: int, g: torch.Generator) -> torch.Tensor:
    """One pass's (|R|, canary_len − prefix_len) int64 continuations."""
    return torch.randint(0, vocab, (mix["pool"],
                                    mix["canary_len"] - mix["prefix_len"]),
                         generator=g, device=g.device)
