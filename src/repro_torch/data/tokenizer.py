"""Fixed-vocabulary word-level tokenizer.

The paper (§I, §V-B) uses a *fixed* 10k word vocabulary as one of its
privacy measures — the vocabulary is not derived from private user data, so
no private information can leak through vocabulary membership. We mirror
that: the vocab is fixed up front (synthetic word list), OOV maps to UNK.
"""
from __future__ import annotations

from typing import Iterable, List

PAD, UNK, BOS, EOS = 0, 1, 2, 3
N_SPECIAL = 4


class Tokenizer:
    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._words = ["<pad>", "<unk>", "<s>", "</s>"] + [
            f"w{i}" for i in range(vocab_size - N_SPECIAL)]
        self._ids = {w: i for i, w in enumerate(self._words)}

    def encode_word(self, w: str) -> int:
        return self._ids.get(w, UNK)

    def encode(self, words: Iterable[str]) -> List[int]:
        return [self.encode_word(w) for w in words]

    def decode(self, ids: Iterable[int]) -> List[str]:
        return [self._words[i] if 0 <= i < self.vocab_size else "<unk>"
                for i in ids]
