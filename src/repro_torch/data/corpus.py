"""Synthetic training corpus with learnable structure.

Stand-in for the paper's Stack Overflow (tuning) and on-device Spanish
(production) corpora, which are unavailable offline. Sentences are random
walks over a sparse Zipf-weighted bigram graph, so a trained LM can beat the
unigram baseline by a wide margin (the signal the recall benchmark needs),
while word marginals stay Zipfian like natural text.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.data.tokenizer import BOS, EOS, N_SPECIAL


@dataclass
class BigramCorpus:
    vocab_size: int
    branching: int = 8         # successors per word
    zipf_a: float = 1.3
    n_topics: int = 1          # >1: per-sentence latent topic switches the
    seed: int = 0              # transition table — structure an n-gram LM
                               # cannot condition on, but a recurrent model
                               # can infer from the sentence prefix (this is
                               # what lets the NWP model beat the FST
                               # baseline, mirroring the paper's Table 2)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n = self.vocab_size - N_SPECIAL
        # Zipf marginals over real words
        ranks = np.arange(1, n + 1, dtype=np.float64)
        self.unigram = ranks ** (-self.zipf_a)
        self.unigram /= self.unigram.sum()
        # per-topic sparse successor sets
        self.succ = rng.choice(n, size=(self.n_topics, n, self.branching),
                               replace=True, p=self.unigram)
        self.succ_p = rng.dirichlet(np.full(self.branching, 0.25),
                                    size=(self.n_topics, n))

    def sample_sentence(self, rng: np.random.Generator,
                        min_len: int = 4, max_len: int = 12) -> List[int]:
        n = self.vocab_size - N_SPECIAL
        t = int(rng.integers(self.n_topics))
        length = int(rng.integers(min_len, max_len + 1))
        w = int(rng.choice(n, p=self.unigram))
        out = [BOS, w + N_SPECIAL]
        for _ in range(length - 1):
            j = int(rng.choice(self.branching, p=self.succ_p[t, w]))
            w = int(self.succ[t, w, j])
            out.append(w + N_SPECIAL)
        out.append(EOS)
        return out

    def sample_sentences(self, n_sentences: int, seed: int) -> List[List[int]]:
        rng = np.random.default_rng(seed)
        return [self.sample_sentence(rng) for _ in range(n_sentences)]

    def bigram_topk(self, prev_token: int, k: int = 3,
                    topic: int = 0) -> List[int]:
        """Oracle top-k successors (upper bound for recall benchmarks)."""
        if prev_token < N_SPECIAL:
            top = np.argsort(-self.unigram)[:k]
            return [int(t) + N_SPECIAL for t in top]
        w = prev_token - N_SPECIAL
        order = np.argsort(-self.succ_p[topic, w])[:k]
        return [int(self.succ[topic, w, j]) + N_SPECIAL for j in order]
