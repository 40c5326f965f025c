"""Katz-smoothed backoff n-gram LM — the paper's baseline (§III): the
port's own copy of ``repro.data.ngram``, numpy and the standard library
only, so that the port imports nothing of the JAX package.

The production baseline is a Katz-smoothed Bayesian-interpolated n-gram FST
augmented with a user-history LM; we implement the core Katz backoff trigram
(absolute discounting variant) which is the dominant component, and an
optional per-user history unigram interpolation to mirror the "personalized
components" note under Table 2.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class KatzTrigramLM:
    def __init__(self, vocab_size: int, discount: float = 0.4):
        self.vocab_size = vocab_size
        self.discount = discount
        self.uni = Counter()
        self.bi: Dict[int, Counter] = defaultdict(Counter)
        self.tri: Dict[Tuple[int, int], Counter] = defaultdict(Counter)
        self.total = 0

    def fit(self, sentences: Sequence[Sequence[int]]) -> "KatzTrigramLM":
        for s in sentences:
            for i, w in enumerate(s):
                self.uni[w] += 1
                self.total += 1
                if i >= 1:
                    self.bi[s[i - 1]][w] += 1
                if i >= 2:
                    self.tri[(s[i - 2], s[i - 1])][w] += 1
        return self

    def _backoff_scores(self, counts: Counter, lower: Dict[int, float],
                        d: float) -> Dict[int, float]:
        total = sum(counts.values())
        if total == 0:
            return dict(lower)
        scores = {w: max(c - d, 0.0) / total for w, c in counts.items()}
        mass = d * len(counts) / total
        z = sum(p for w, p in lower.items() if w not in counts) or 1e-12
        for w, p in lower.items():
            if w not in scores:
                scores[w] = mass * p / z
        return scores

    def next_word_scores(self, context: Sequence[int],
                         history: Optional[Counter] = None,
                         history_weight: float = 0.1) -> Dict[int, float]:
        uni_p = {w: c / max(self.total, 1) for w, c in self.uni.items()}
        bi_p = (self._backoff_scores(self.bi.get(context[-1], Counter()),
                                     uni_p, self.discount)
                if context else uni_p)
        if len(context) >= 2:
            key = (context[-2], context[-1])
            scores = self._backoff_scores(self.tri.get(key, Counter()),
                                          bi_p, self.discount)
        else:
            scores = bi_p
        if history:
            htot = sum(history.values())
            out = {w: (1 - history_weight) * p for w, p in scores.items()}
            for w, c in history.items():
                out[w] = out.get(w, 0.0) + history_weight * c / htot
            return out
        return scores

    def topk(self, context: Sequence[int], k: int = 3,
             history: Optional[Counter] = None) -> List[int]:
        scores = self.next_word_scores(context, history)
        return [w for w, _ in sorted(scores.items(),
                                     key=lambda x: -x[1])[:k]]


def recall_at_k(lm: KatzTrigramLM, sentences: Sequence[Sequence[int]],
                k: int = 1) -> float:
    """top-k recall: correct next-word predictions / total words (§III-A)."""
    hit, total = 0, 0
    for s in sentences:
        for i in range(1, len(s)):
            pred = lm.topk(s[max(0, i - 2):i], k)
            hit += int(s[i] in pred)
            total += 1
    return hit / max(total, 1)
