"""User-sharded federated dataset (the reference's ``data/federated.py``).

Mirrors the paper's setup (§IV-A): devices hold sentences from the corpus,
under a per-user example cap (one of the paper's privacy measures). The
numpy draws are the reference's, so a seed gives both packages the same
users and the same client batches. Secret-sharing synthetic devices
(canary injection) arrive with the port of the Secret Sharer.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.tokenizer import PAD


def sentences_to_examples(sentences: Sequence[Sequence[int]], seq_len: int,
                          max_examples: Optional[int] = None) -> np.ndarray:
    """Pack sentences into fixed (n, seq_len+1) windows (inputs+shifted labels
    share the window; PAD-masked loss). One sentence per window."""
    if max_examples is not None and max_examples < 0:
        raise ValueError(f"max_examples must be >= 0, got {max_examples}")
    rows = []
    for s in sentences:
        # an explicit cap of 0 means zero examples, not "no cap"
        if max_examples is not None and len(rows) >= max_examples:
            break
        s = list(s)[: seq_len + 1]
        rows.append(s + [PAD] * (seq_len + 1 - len(s)))
    if not rows:
        return np.zeros((0, seq_len + 1), np.int32)
    return np.asarray(rows, np.int32)


def examples_to_batch(ex: np.ndarray) -> Dict[str, np.ndarray]:
    tokens = ex[:, :-1]
    labels = ex[:, 1:]
    mask = (labels != PAD).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


@dataclass
class UserShard:
    user_id: int
    examples: np.ndarray          # (n, seq_len+1) int32
    is_synthetic: bool = False    # secret-sharing device?


@dataclass
class FederatedDataset:
    corpus: BigramCorpus
    n_users: int
    seq_len: int = 16
    sentences_per_user: int = 40
    max_examples_per_user: int = 200  # the paper's per-user cap
    seed: int = 0
    users: List[UserShard] = field(default_factory=list)

    def __post_init__(self):
        for uid in range(self.n_users):
            sents = self.corpus.sample_sentences(
                min(self.sentences_per_user, self.max_examples_per_user),
                seed=self.seed * 1_000_003 + uid)
            self.users.append(UserShard(
                uid, sentences_to_examples(sents, self.seq_len,
                                           self.max_examples_per_user)))

    def user_batches(self, user_id: int, batch_size: int,
                     rng: np.random.Generator) -> List[Dict[str, np.ndarray]]:
        """Split a user's (shuffled) examples into size-B batches (last batch
        padded by repetition so shapes stay static for jit)."""
        ex = self.users[user_id].examples
        perm = rng.permutation(ex.shape[0])
        ex = ex[perm]
        n = ex.shape[0]
        batches = []
        for i in range(0, n, batch_size):
            chunk = ex[i:i + batch_size]
            if chunk.shape[0] < batch_size:
                reps = np.resize(np.arange(chunk.shape[0]), batch_size)
                chunk = chunk[reps]
            batches.append(examples_to_batch(chunk))
        return batches

    def user_tensor(self, user_id: int, batch_size: int, n_batches: int,
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
        """Fixed-shape (n_batches, B, S) stack for the vmapped/jit round path;
        examples are tiled if the user has fewer than n_batches·B."""
        ex = self.users[user_id].examples
        if ex.shape[0] == 0:
            raise ValueError(
                f"user {user_id} holds zero examples — cannot tile an empty "
                "shard into a fixed-shape client tensor (np.resize on an "
                "empty range tiles garbage); give the user data or exclude "
                "it from sampling")
        need = n_batches * batch_size
        idx = rng.permutation(np.resize(np.arange(ex.shape[0]), need))
        ex = ex[idx].reshape(n_batches, batch_size, -1)
        out = {"tokens": ex[:, :, :-1], "labels": ex[:, :, 1:]}
        out["mask"] = (out["labels"] != PAD).astype(np.float32)
        return out


def held_out_batch(corpus: BigramCorpus, n: int, seq_len: int,
                   seed: int = 999) -> Dict[str, np.ndarray]:
    ex = sentences_to_examples(corpus.sample_sentences(n, seed), seq_len)
    return examples_to_batch(ex)
