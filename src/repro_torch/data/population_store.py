"""Host-resident population corpus behind a per-round cohort gather (the
reference's ``data/population_store.py``, numpy only).

``FederatedDataset.to_device_arrays()`` puts the *whole* padded corpus on
the device: N · E_max · (seq_len+1) · 4 bytes, which outgrows the card long
before the paper's fleet of millions of phones. A :class:`PopulationStore`
keeps the corpus on the host (RAM or memory-mapped disk shards) and serves
one cohort's examples a round to the streamed engine backend
(`repro_torch.fl.engine.SimEngine(population_backend="streamed")`).

The stored arrays are the device backend's, row for row:

* ``examples`` — (N, E_max, seq_len+1) int32, each user's real examples
  **tiled** to E_max so every slot holds a valid example;
* ``counts`` — (N,) int32 true example counts (the engine draws uniform
  indices in ``[0, counts[u])``, so tiling never skews the draw);
* ``synthetic`` — (N,) bool Secret Sharer mask.

A store serves for user ``u`` exactly row ``u`` of the device tensor, so
the streamed backend's trajectories are bitwise the device backend's.

Three implementations:

* :class:`InMemoryPopulationStore` — numpy arrays in host RAM;
* :class:`MmapPopulationStore` — a directory of fixed-size user shards
  (``examples-00000-of-00004.npy`` …) opened with ``np.load(mmap_mode="r")``,
  so the OS pages in only the users a round touches. Written by
  :func:`write_population_store` or ``python -m
  repro_torch.launch.build_corpus``. The format is the reference's byte for
  byte: a store written by either package opens in the other;
* :class:`ReplicatedPopulationStore` — a view tiling a base store to N users
  (``uid → uid % base.n_users``) that copies only the per-user vectors:
  a 10⁶–10⁷-user fleet without a 10-GB corpus on disk.

The small per-user vectors (``counts``, ``synthetic``) always live in host
RAM, 5 bytes a user; only the example payload is sharded, mapped or
virtualized.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

__all__ = ["DEFAULT_SHARD_USERS", "InMemoryPopulationStore",
           "MmapPopulationStore", "PopulationStore",
           "ReplicatedPopulationStore", "STORE_META", "STORE_VERSION",
           "as_population_store", "write_population_store"]

STORE_META = "meta.json"
STORE_VERSION = 1
DEFAULT_SHARD_USERS = 4096


def _validate_arrays(examples: np.ndarray, counts: np.ndarray,
                     synthetic: np.ndarray) -> None:
    if examples.ndim != 3:
        raise ValueError(f"examples must be (N, E_max, seq_len+1), got "
                         f"shape {examples.shape}")
    n = examples.shape[0]
    if counts.shape != (n,) or synthetic.shape != (n,):
        raise ValueError(
            f"counts {counts.shape} / synthetic {synthetic.shape} must both "
            f"be ({n},) to match examples {examples.shape}")
    if n and int(counts.min()) < 1:
        empty = np.nonzero(np.asarray(counts) < 1)[0][:5]
        raise ValueError(
            f"population store: users {empty.tolist()} have no examples — "
            "every user must hold >= 1 example (the engine draws indices in "
            "[0, counts[u]) and tiling an empty shard is undefined); drop "
            "them upstream or give them data")


class PopulationStore:
    """Read-only host-side population corpus: per-user tiled example rows
    plus the small per-user vectors. Subclasses implement :meth:`gather`."""

    n_users: int
    emax: int          # examples per user after tiling (E_max)
    row_len: int       # seq_len + 1 (the window with its shifted label)
    counts: np.ndarray     # (N,) int32
    synthetic: np.ndarray  # (N,) bool

    def gather(self, ids) -> np.ndarray:
        """(len(ids), E_max, seq_len+1) int32 tiled example rows for the
        given user ids (any order; duplicates are fine — a padded cohort
        aliases slot 0)."""
        raise NotImplementedError

    def gather_counts(self, ids) -> np.ndarray:
        return np.ascontiguousarray(self.counts[np.asarray(ids, np.int64)],
                                    dtype=np.int32)

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """The whole population as the device backend's dict (the round-trip
        test oracle). O(N·E_max·seq_len) host memory: small N only."""
        return {"examples": self.gather(np.arange(self.n_users)),
                "counts": np.asarray(self.counts, np.int32),
                "synthetic": np.asarray(self.synthetic, bool)}

    @property
    def nbytes_per_user(self) -> int:
        return self.emax * self.row_len * 4

    def _check_ids(self, ids) -> np.ndarray:
        ids = np.asarray(ids, np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_users):
            raise IndexError(
                f"user ids out of range [0, {self.n_users}): "
                f"[{ids.min()}, {ids.max()}]")
        return ids


class InMemoryPopulationStore(PopulationStore):
    """Population corpus in host RAM — the small-run path and the base the
    replicated and mmap stores are built from."""

    def __init__(self, examples: np.ndarray, counts: np.ndarray,
                 synthetic: np.ndarray):
        examples = np.asarray(examples, np.int32)
        counts = np.asarray(counts, np.int32)
        synthetic = np.asarray(synthetic, bool)
        _validate_arrays(examples, counts, synthetic)
        self.examples = examples
        self.counts = counts
        self.synthetic = synthetic
        self.n_users = int(examples.shape[0])
        self.emax = int(examples.shape[1])
        self.row_len = int(examples.shape[2])

    @classmethod
    def from_arrays(cls, data: Dict[str, np.ndarray]
                    ) -> "InMemoryPopulationStore":
        """From a ``FederatedDataset.to_device_arrays()``-style dict."""
        return cls(data["examples"], data["counts"], data["synthetic"])

    @classmethod
    def from_dataset(cls, dataset, max_examples: Optional[int] = None
                     ) -> "InMemoryPopulationStore":
        """From a ``FederatedDataset``, tiled as ``to_device_arrays`` tiles,
        so the two representations are bitwise equal."""
        return cls.from_arrays(dataset.to_device_arrays(max_examples))

    def gather(self, ids) -> np.ndarray:
        return np.ascontiguousarray(self.examples[self._check_ids(ids)])


class ReplicatedPopulationStore(PopulationStore):
    """An N-user view over a base store: ``uid → uid % base_n``.

    Only the per-user vectors are tiled (5 bytes a user). The Secret
    Sharer's semantics do not survive replication (a canary's n_u
    multiplies), so this view measures throughput and memory, not
    memorization."""

    def __init__(self, base: PopulationStore, n_users: int):
        if n_users < base.n_users:
            raise ValueError(f"n_users={n_users} must be >= the base "
                             f"store's {base.n_users}")
        self.base = base
        self.n_users = int(n_users)
        self.emax = base.emax
        self.row_len = base.row_len
        reps = -(-self.n_users // base.n_users)
        self.counts = np.tile(base.counts, reps)[: self.n_users]
        self.synthetic = np.tile(base.synthetic, reps)[: self.n_users]

    def gather(self, ids) -> np.ndarray:
        return self.base.gather(self._check_ids(ids) % self.base.n_users)


class MmapPopulationStore(PopulationStore):
    """On-disk population store: ``meta.json`` + ``counts.npy`` +
    ``synthetic.npy`` + fixed-size user shards
    ``examples-00000-of-00004.npy``, each a (shard_users, E_max, seq_len+1)
    int32 ``.npy`` opened lazily with ``np.load(mmap_mode="r")``: host RSS
    grows with the users a gather touches, not with N."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        meta_path = self.path / STORE_META
        if not meta_path.is_file():
            raise FileNotFoundError(
                f"{self.path} is not a population store (no {STORE_META}); "
                "build one with python -m repro_torch.launch.build_corpus "
                "or write_population_store()")
        self.meta = json.loads(meta_path.read_text())
        if self.meta.get("version") != STORE_VERSION:
            raise ValueError(f"population store version "
                             f"{self.meta.get('version')} != reader version "
                             f"{STORE_VERSION} ({meta_path})")
        self.n_users = int(self.meta["n_users"])
        self.emax = int(self.meta["emax"])
        self.row_len = int(self.meta["row_len"])
        self.shard_users = int(self.meta["shard_users"])
        self.n_shards = int(self.meta["n_shards"])
        self.counts = np.load(self.path / "counts.npy")
        self.synthetic = np.load(self.path / "synthetic.npy")
        expect = -(-self.n_users // self.shard_users)
        if self.n_shards != expect:
            raise ValueError(
                f"corrupt store: n_shards={self.n_shards} but "
                f"{self.n_users} users / {self.shard_users} per shard "
                f"needs {expect}")
        self._shards: Dict[int, np.ndarray] = {}

    def shard_file(self, s: int) -> Path:
        return self.path / f"examples-{s:05d}-of-{self.n_shards:05d}.npy"

    def _shard(self, s: int) -> np.ndarray:
        if s not in self._shards:
            self._shards[s] = np.load(self.shard_file(s), mmap_mode="r")
        return self._shards[s]

    def gather(self, ids) -> np.ndarray:
        ids = self._check_ids(ids)
        out = np.empty((ids.shape[0], self.emax, self.row_len), np.int32)
        shard_of = ids // self.shard_users
        for s in np.unique(shard_of):
            sel = shard_of == s
            out[sel] = self._shard(int(s))[ids[sel] - s * self.shard_users]
        return out


def write_population_store(path: Union[str, Path], store: PopulationStore,
                           shard_users: int = DEFAULT_SHARD_USERS,
                           seq_len: Optional[int] = None) -> Path:
    """Write any :class:`PopulationStore` in the sharded mmap format, one
    shard at a time through :meth:`PopulationStore.gather`, so a replicated
    10⁶-user store needs O(shard) host memory."""
    if shard_users < 1:
        raise ValueError(f"shard_users must be >= 1, got {shard_users}")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    n = store.n_users
    n_shards = -(-n // shard_users)
    for s in range(n_shards):
        lo, hi = s * shard_users, min((s + 1) * shard_users, n)
        block = store.gather(np.arange(lo, hi))
        np.save(path / f"examples-{s:05d}-of-{n_shards:05d}.npy", block)
    np.save(path / "counts.npy", np.asarray(store.counts, np.int32))
    np.save(path / "synthetic.npy", np.asarray(store.synthetic, bool))
    meta = {"version": STORE_VERSION, "n_users": n, "emax": store.emax,
            "row_len": store.row_len,
            "seq_len": int(seq_len if seq_len is not None
                           else store.row_len - 1),
            "shard_users": int(shard_users), "n_shards": n_shards,
            "dtype": "int32"}
    (path / STORE_META).write_text(json.dumps(meta, indent=1))
    return path


def as_population_store(data) -> PopulationStore:
    """The engine's ``data`` argument as a store: a store passes through, a
    ``to_device_arrays()``-style dict or a ``FederatedDataset`` is wrapped
    in memory, a path opens the on-disk format."""
    if isinstance(data, PopulationStore):
        return data
    if isinstance(data, dict):
        return InMemoryPopulationStore.from_arrays(data)
    if isinstance(data, (str, Path)):
        return MmapPopulationStore(data)
    if hasattr(data, "to_device_arrays"):
        return InMemoryPopulationStore.from_dataset(data)
    raise TypeError(
        f"expected a PopulationStore, a FederatedDataset, a "
        f"to_device_arrays() dict or a store path, got {type(data).__name__}")
