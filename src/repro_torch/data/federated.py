"""User-sharded federated dataset (the reference's ``data/federated.py``).

Mirrors the paper's setup (§IV-A): devices hold sentences from the corpus,
under a per-user example cap (one of the paper's privacy measures);
*secret-sharing synthetic devices* hold ``n_e`` copies of their canary plus
``(200 − n_e)`` public-corpus sentences. The numpy draws are the
reference's, so a seed (and, for canaries, the same canary list) gives both
packages the same users, the same client batches and the same
`to_device_arrays` bytes.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.secret_sharer import Canary
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.tokenizer import PAD

USER_SENTENCES = 200  # paper: synthetic devices hold 200 examples total


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
    canary: Optional[Canary] = None


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

    def inject_canaries(self, canaries: Sequence[Canary]) -> List[UserShard]:
        """Create the paper's secret-sharing synthetic devices: for each
        canary, n_u devices each holding n_e canary copies + (200−n_e) public
        sentences. Appends them to the population; returns them.

        Canaries must have pairwise-distinct 2-word prefixes — duplicates
        included (injecting the same canary twice would silently double its
        n_u). Beam-search extraction conditions on the prefix;
        `make_canaries` already guarantees distinctness, hand-built lists
        are validated here."""
        prefixes = [c.prefix for c in canaries]
        if len(set(prefixes)) != len(prefixes):
            raise ValueError("injected canaries share a beam-search prefix "
                             "(or repeat a canary — n_u controls device "
                             "count); redraw them (see make_canaries)")
        synthetic = []
        next_id = len(self.users)
        for ci, c in enumerate(canaries):
            for u in range(c.n_u):
                n_e = min(c.n_e, USER_SENTENCES)
                pub = self.corpus.sample_sentences(
                    USER_SENTENCES - n_e,
                    seed=777_000_000 + ci * 1_000 + u)
                sents = [list(c.tokens)] * n_e + pub
                shard = UserShard(next_id,
                                  sentences_to_examples(sents, self.seq_len,
                                                        USER_SENTENCES),
                                  is_synthetic=True, canary=c)
                self.users.append(shard)
                synthetic.append(shard)
                next_id += 1
        return synthetic

    def canaries(self) -> List[Canary]:
        """Distinct injected canaries, in injection order — index-aligned
        with the (K,) outputs of `repro_torch.core.secret_sharer.
        canary_eval_fn` built from this list."""
        return list(dict.fromkeys(
            u.canary for u in self.users if u.canary is not None))

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

    def to_device_arrays(self, max_examples: Optional[int] = None
                         ) -> Dict[str, np.ndarray]:
        """Pack the whole population into fixed-shape arrays for the
        simulation engine (`repro_torch.fl.engine`):

        * ``examples`` — (n_users, E_max, seq_len+1) int32. Users with fewer
          than E_max examples are padded by *tiling* their real examples, so
          every slot holds a valid example regardless of the index used.
        * ``counts`` — (n_users,) int32 true example counts (the engine draws
          uniform indices in [0, counts[u]) so tiled padding never skews the
          per-example distribution).
        * ``synthetic`` — (n_users,) bool secret-sharer mask (always
          available, exempt from Pace Steering).
        """
        n = len(self.users)
        empty = [u.user_id for u in self.users if u.examples.shape[0] == 0]
        if empty:
            raise ValueError(
                f"users {empty[:5]} hold zero examples — tiling an empty "
                "shard would silently serve garbage (np.resize on an empty "
                "range tiles nothing); give them data or drop them")
        emax = (max_examples if max_examples is not None
                else max(u.examples.shape[0] for u in self.users))
        if emax < 1:
            raise ValueError(f"max_examples must be >= 1 for the padded "
                             f"corpus tensor, got {max_examples}")
        ex = np.zeros((n, emax, self.seq_len + 1), np.int32)
        counts = np.zeros((n,), np.int32)
        synth = np.zeros((n,), bool)
        for i, u in enumerate(self.users):
            c = min(u.examples.shape[0], emax)
            ex[i] = u.examples[np.resize(np.arange(c), emax)]
            counts[i] = c
            synth[i] = u.is_synthetic
        return {"examples": ex, "counts": counts, "synthetic": synth}

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
