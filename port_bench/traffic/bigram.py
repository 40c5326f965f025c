"""The synthetic corpus's arithmetic (a Zipf-weighted sparse bigram walk,
as the port's ``data.corpus.BigramCorpus`` defines it), rewritten in
PyTorch to draw millions of sentences at once on the card.

Words ``w`` in ``[0, vocab − 4)`` are token ``w + 4`` (ids 0–3 are PAD,
UNK, BOS, EOS). The unigram is ``rank^(−a)`` normalised; each (topic,
word) has ``branching`` successors drawn from the unigram and their
probabilities from Dirichlet(0.25). A sentence is BOS, a first word from
the unigram, ``length − 1`` successor steps under one topic, EOS, with
``length`` uniform in ``[min_len, max_len]``.
"""
from __future__ import annotations

import torch

PAD, UNK, BOS, EOS = 0, 1, 2, 3
N_SPECIAL = 4


def _gamma(alpha: float, shape, g: torch.Generator) -> torch.Tensor:
    """Gamma(alpha) draws (alpha < 1): Marsaglia–Tsang at alpha + 1, eight
    candidates an element, the first accepted taken (all eight are
    rejected with probability below 1e-10), times U^(1/alpha)."""
    dev = g.device
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    x = torch.randn((8,) + tuple(shape), generator=g, device=dev,
                    dtype=torch.float64)
    u = torch.rand((8,) + tuple(shape), generator=g, device=dev,
                   dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp(min=1e-300)))
    first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
    val = torch.gather(d * v, 0, first)[0]
    boost = torch.rand(tuple(shape), generator=g, device=dev,
                       dtype=torch.float64) ** (1.0 / alpha)
    return val * boost


class Bigram:
    """The corpus tables of one seed, on the generator's device."""

    def __init__(self, vocab: int, g: torch.Generator, branching: int = 8,
                 zipf_a: float = 1.3, n_topics: int = 1):
        n = vocab - N_SPECIAL
        dev = g.device
        ranks = torch.arange(1, n + 1, dtype=torch.float64, device=dev)
        uni = ranks ** (-zipf_a)
        self.unigram_cdf = torch.cumsum(uni / uni.sum(), 0)
        self.n, self.branching, self.n_topics = n, branching, n_topics
        self.succ = self.unigram_words(n_topics * n * branching, g).reshape(
            n_topics, n, branching)
        gam = _gamma(0.25, (n_topics, n, branching), g)
        p = gam / gam.sum(-1, keepdim=True)
        self.succ_cdf = torch.cumsum(p, -1).to(torch.float32)

    def unigram_words(self, m: int, g: torch.Generator) -> torch.Tensor:
        u = torch.rand((m,), generator=g, device=g.device,
                       dtype=torch.float64)
        return torch.searchsorted(self.unigram_cdf, u).clamp(max=self.n - 1)

    def sentences(self, m: int, g: torch.Generator, min_len: int,
                  max_len: int):
        """``m`` sentences → (tokens (m, max_len + 2) int32 with BOS …
        EOS and PAD after it, lengths in tokens (m,) int64)."""
        dev = g.device
        topic = torch.randint(0, self.n_topics, (m,), generator=g,
                              device=dev)
        length = torch.randint(min_len, max_len + 1, (m,), generator=g,
                               device=dev)
        w = self.unigram_words(m, g)
        words = [w]
        for _ in range(max_len - 1):
            u = torch.rand((m, 1), generator=g, device=dev)
            k = (u > self.succ_cdf[topic, w]).sum(-1).clamp(
                max=self.branching - 1)
            w = self.succ[topic, w, k]
            words.append(w)
        words = torch.stack(words, 1) + N_SPECIAL                 # (m, L)
        pos = torch.arange(max_len, device=dev)
        words = torch.where(pos < length[:, None], words, PAD)
        out = torch.full((m, max_len + 2), PAD, dtype=torch.int64,
                         device=dev)
        out[:, 0] = BOS
        out[:, 1:max_len + 1] = words
        out.scatter_(1, (length + 1)[:, None], EOS)
        return out.to(torch.int32), length + 2
