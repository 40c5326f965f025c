"""A federated population as the simulation engine takes it: ``examples``
(N, E_max, seq_len + 1) int32 on the host, ``counts`` (N,) int32 and
``synthetic`` (N,) bool, drawn on the card from one generator.

Mix keys (``traffic/<name>.json``): ``kind`` (``sentences`` or
``packed``), ``n_users``, ``examples_min`` / ``examples_max`` (a user's
count, uniform), ``seq_len``, ``sentence_min`` / ``sentence_max`` (words),
and the corpus's ``branching``, ``zipf_a`` and ``n_topics``. Users are
made in blocks of ``BLOCK`` so the draws' temporaries stay small.
"""
from __future__ import annotations

from typing import Dict

import torch

from port_bench.traffic.bigram import PAD, Bigram

BLOCK = 4096


def _rows_sentences(corpus, m, g, mix):
    tok, _ = corpus.sentences(m, g, mix["sentence_min"], mix["sentence_max"])
    width = mix["seq_len"] + 1
    if tok.shape[1] > width:
        raise ValueError(f"sentences of up to {mix['sentence_max']} words "
                         f"do not fit rows of {width} tokens")
    return torch.nn.functional.pad(tok, (0, width - tok.shape[1]),
                                   value=PAD)


def _rows_packed(corpus, m, g, mix):
    """``m`` rows of ``seq_len + 1`` tokens, each sentences back to back
    (BOS … EOS BOS …), cut at the row's end: no padding."""
    width = mix["seq_len"] + 1
    per = -(-width // (mix["sentence_min"] + 2)) + 1
    tok, lens = corpus.sentences(m * per, g, mix["sentence_min"],
                                 mix["sentence_max"])
    tok, lens = tok.reshape(m, per, -1), lens.reshape(m, per)
    start = torch.cumsum(lens, 1) - lens                        # (m, per)
    j = torch.arange(tok.shape[-1], device=tok.device)
    pos = start[..., None] + j                                  # (m, per, L)
    keep = (j < lens[..., None]) & (pos < width)
    row = torch.arange(m, device=tok.device)[:, None, None].expand_as(pos)
    out = torch.full((m, width), PAD, dtype=torch.int32, device=tok.device)
    out[row[keep], pos[keep]] = tok[keep]
    return out


def population(mix: dict, vocab: int, g: torch.Generator
               ) -> Dict[str, torch.Tensor]:
    """The population of ``mix`` for a model of ``vocab`` tokens: examples
    on the host, counts and the synthetic mask on the generator's
    device."""
    corpus = Bigram(vocab, g, mix["branching"], mix["zipf_a"],
                    mix["n_topics"])
    make = {"sentences": _rows_sentences, "packed": _rows_packed}[mix["kind"]]
    n, emax = mix["n_users"], mix["examples_max"]
    examples = torch.empty((n, emax, mix["seq_len"] + 1), dtype=torch.int32)
    for u0 in range(0, n, BLOCK):
        b = min(BLOCK, n - u0)
        examples[u0:u0 + b] = make(corpus, b * emax, g, mix).reshape(
            b, emax, -1).cpu()
    counts = torch.randint(mix["examples_min"], emax + 1, (n,), generator=g,
                           device=g.device).to(torch.int32)
    return {"examples": examples, "counts": counts,
            "synthetic": torch.zeros((n,), dtype=torch.bool,
                                     device=g.device)}
