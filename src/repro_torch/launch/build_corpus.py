"""Build an on-disk population store for the streamed engine backend (the
port of the reference's ``tools/build_corpus.py``, with its flags).

    PYTHONPATH=src python -m repro_torch.launch.build_corpus --out /tmp/pop \\
        --n-users 1000000 --vocab 2000 --seq-len 16 --shard-users 4096

Synthesizes a `BigramCorpus`-backed federated population (the generator of
the simulation's `FederatedDataset`, so a small store is bitwise
``to_device_arrays()`` of the same dataset) and writes it in the sharded
mmap format of `repro_torch.data.population_store`:

    out/
      meta.json                       version, n_users, emax, row_len, ...
      counts.npy                      (N,) int32 true example counts
      synthetic.npy                   (N,) bool Secret Sharer mask
      examples-00000-of-00NNN.npy     (shard_users, E_max, seq_len+1) int32

Users are generated and written one shard at a time, so a 10⁶-user store
needs O(shard_users · E_max · seq_len) host memory, not O(N). Without
canaries the files are byte for byte the reference tool's for the same
flags.

``--inject-canaries`` appends the paper's secret-sharing synthetic devices
(n_u devices per canary, each holding n_e canary copies and public filler)
at the end of the id space and writes the canaries to ``canaries.json``
beside the store. They are drawn by the port's `core.secret_sharer`
(another generator than the reference's, so these stores differ).

``--replicate N`` tiles the synthesized base population to N users
through `ReplicatedPopulationStore` before writing: a quick way to a large
corpus for throughput runs (the Secret Sharer's semantics do not survive
replication).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core.secret_sharer import make_canaries
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import (USER_SENTENCES, FederatedDataset,
                                        sentences_to_examples)
from repro_torch.data.population_store import (DEFAULT_SHARD_USERS,
                                               InMemoryPopulationStore,
                                               MmapPopulationStore,
                                               PopulationStore,
                                               ReplicatedPopulationStore,
                                               write_population_store)


def _dataset_store(args):
    """Small populations: through `FederatedDataset`, so the store is
    bitwise the simulation's in-memory corpus (canaries included). Returns
    ``(InMemoryPopulationStore, canaries)``."""
    corpus = BigramCorpus(vocab_size=args.vocab, seed=args.seed)
    ds = FederatedDataset(corpus, n_users=args.n_users, seq_len=args.seq_len,
                          sentences_per_user=args.sentences_per_user,
                          seed=args.seed)
    canaries = []
    if args.inject_canaries:
        canaries = make_canaries(torch.Generator().manual_seed(42),
                                 vocab=args.vocab)
        ds.inject_canaries(canaries)
    return InMemoryPopulationStore.from_dataset(ds), canaries


class _SynthesizedStore(PopulationStore):
    """Per-shard synthesis for a large ``--n-users``: each user's sentences
    are generated when gathered, from the per-user seed `FederatedDataset`
    uses, so a store built shard by shard equals one built at once."""

    def __init__(self, args):
        self.args = args
        self.corpus = BigramCorpus(vocab_size=args.vocab, seed=args.seed)
        self.n_users = args.n_users
        self.emax = min(args.sentences_per_user, USER_SENTENCES)
        self.row_len = args.seq_len + 1
        self.counts = np.full((self.n_users,), self.emax, np.int32)
        self.synthetic = np.zeros((self.n_users,), bool)

    def gather(self, ids) -> np.ndarray:
        ids = self._check_ids(ids)
        out = np.empty((ids.shape[0], self.emax, self.row_len), np.int32)
        a = self.args
        for i, uid in enumerate(ids):
            sents = self.corpus.sample_sentences(
                self.emax, seed=a.seed * 1_000_003 + int(uid))
            ex = sentences_to_examples(sents, a.seq_len, self.emax)
            out[i] = ex[np.resize(np.arange(ex.shape[0]), self.emax)]
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True, help="store directory to create")
    ap.add_argument("--n-users", type=int, default=1000)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--sentences-per-user", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--shard-users", type=int, default=DEFAULT_SHARD_USERS)
    ap.add_argument("--inject-canaries", action="store_true",
                    help="append secret-sharing devices and write "
                         "canaries.json (small populations only)")
    ap.add_argument("--replicate", type=int, default=None, metavar="N",
                    help="tile the synthesized base to N users before "
                         "writing (throughput corpora; breaks the Secret "
                         "Sharer's semantics)")
    ap.add_argument("--dataset-path", action="store_true",
                    help="build through FederatedDataset even for a large "
                         "--n-users (O(N) host memory)")
    args = ap.parse_args(argv)

    t0 = time.time()
    canaries = []
    if args.inject_canaries or args.dataset_path or args.n_users <= 20_000:
        store, canaries = _dataset_store(args)
    else:
        store = _SynthesizedStore(args)
    if args.replicate is not None:
        store = ReplicatedPopulationStore(store, args.replicate)

    path = write_population_store(args.out, store,
                                  shard_users=args.shard_users,
                                  seq_len=args.seq_len)
    if canaries:
        (path / "canaries.json").write_text(json.dumps(
            [{"prefix": list(c.prefix), "tokens": list(c.tokens),
              "n_u": c.n_u, "n_e": c.n_e} for c in canaries], indent=1))

    back = MmapPopulationStore(path)  # reopening validates the layout
    payload = back.n_users * back.emax * back.row_len * 4
    print(f"wrote {back.n_users} users ({back.n_shards} shards, "
          f"E_max={back.emax}, seq_len={back.row_len - 1}, "
          f"{payload / 1e6:.1f} MB payload"
          + (f", {len(canaries)} canaries" if canaries else "")
          + f") to {path} in {time.time() - t0:.1f}s")
    return path


if __name__ == "__main__":
    main()
