"""The port's copy of the Katz backoff trigram baseline
(`repro_torch.data.ngram`) against the reference's ``repro.data.ngram``
on a seeded bigram corpus: both are numpy and the standard library, so
every score, top-k list and recall is held bitwise (exact equality).
"""
import pytest

from repro.data.ngram import KatzTrigramLM as JKatz
from repro.data.ngram import recall_at_k as j_recall
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.ngram import KatzTrigramLM, recall_at_k

VOCAB = 300


@pytest.fixture(scope="module")
def data():
    corpus = BigramCorpus(vocab_size=VOCAB, seed=0)
    train = corpus.sample_sentences(400, seed=2)
    test = corpus.sample_sentences(40, seed=3)
    return (train, test, KatzTrigramLM(VOCAB).fit(train),
            JKatz(VOCAB).fit(train))


def test_counts_match(data):
    _, _, lm, ref = data
    assert lm.total == ref.total and lm.uni == ref.uni
    assert dict(lm.bi) == dict(ref.bi) and dict(lm.tri) == dict(ref.tri)


@pytest.mark.parametrize("history", [False, True])
def test_scores_are_bitwise_the_reference(data, history):
    _, test, lm, ref = data
    from collections import Counter
    for s in test[:15]:
        for i in range(0, min(len(s), 6)):
            ctx = s[max(0, i - 2):i]
            h = Counter(s[:i]) if history and i else None
            assert lm.next_word_scores(ctx, h) == ref.next_word_scores(ctx, h)
            assert lm.topk(ctx, 3, h) == ref.topk(ctx, 3, h)


@pytest.mark.parametrize("k", [1, 3])
def test_recall_is_bitwise_the_reference(data, k):
    _, test, lm, ref = data
    got = recall_at_k(lm, test, k)
    assert got == j_recall(ref, test, k) and 0.0 < got < 1.0
