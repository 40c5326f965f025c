"""The port's population stores (`repro_torch.data.population_store`) and
corpus builder (`repro_torch.launch.build_corpus`), bitwise.

Each store serves exactly the rows fancy indexing of its arrays gives; a
store written by the reference's `write_population_store` opens in the port
and the reverse, with every array equal; the port's builder writes the
reference tool's files (``tools/build_corpus.py``) byte for byte, sha256 of
every file, for the same flags without canaries.
"""
import hashlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.data import population_store as jstore
from repro_torch.core.secret_sharer import make_canaries
from repro_torch.data.corpus import BigramCorpus
from repro_torch.data.federated import FederatedDataset
from repro_torch.data import population_store as pstore
from repro_torch.launch import build_corpus

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def arrays():
    ds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), n_users=30,
                          seq_len=6, sentences_per_user=8)
    data = ds.to_device_arrays()
    data["synthetic"][[3, 17]] = True
    return ds, data


def _ids(n, size=40, seed=0):
    ids = np.random.default_rng(seed).integers(0, n, size)
    ids[:3] = ids[3]                      # a padded cohort aliases slot 0
    return ids


def test_stores_serve_the_rows_of_fancy_indexing(arrays, tmp_path):
    ds, data = arrays
    mem = pstore.InMemoryPopulationStore.from_arrays(data)
    mm = pstore.MmapPopulationStore(pstore.write_population_store(
        tmp_path / "s", mem, shard_users=7))
    for store in (mem, mm, pstore.as_population_store(ds)):
        ids = _ids(30)
        np.testing.assert_array_equal(store.gather(ids),
                                      data["examples"][ids])
        np.testing.assert_array_equal(store.gather_counts(ids),
                                      data["counts"][ids])
        assert (store.n_users, store.emax, store.row_len) == \
            data["examples"].shape
        assert store.nbytes_per_user == data["examples"][0].nbytes
    assert mm.n_shards == 5 and len(list((tmp_path / "s").glob(
        "examples-*-of-00005.npy"))) == 5
    for k, v in mm.device_arrays().items():
        np.testing.assert_array_equal(v, data[k])
        assert v.dtype == data[k].dtype
    with pytest.raises(IndexError):
        mem.gather([0, 30])


def test_replicated_view_tiles_users(arrays):
    _, data = arrays
    base = pstore.InMemoryPopulationStore.from_arrays(data)
    rep = pstore.ReplicatedPopulationStore(base, 95)
    ids = _ids(95, seed=1)
    np.testing.assert_array_equal(rep.gather(ids),
                                  data["examples"][ids % 30])
    np.testing.assert_array_equal(rep.counts, np.tile(data["counts"], 4)[:95])
    np.testing.assert_array_equal(rep.synthetic,
                                  np.tile(data["synthetic"], 4)[:95])
    ref = jstore.ReplicatedPopulationStore(
        jstore.InMemoryPopulationStore.from_arrays(data), 95)
    np.testing.assert_array_equal(rep.gather(ids), ref.gather(ids))
    with pytest.raises(ValueError, match="must be >="):
        pstore.ReplicatedPopulationStore(base, 29)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_store_written_by_one_package_opens_in_the_other(arrays, tmp_path,
                                                           writer):
    _, data = arrays
    w, r = (jstore, pstore) if writer == "reference" else (pstore, jstore)
    path = w.write_population_store(
        tmp_path / "s", w.InMemoryPopulationStore.from_arrays(data),
        shard_users=8, seq_len=6)
    back = r.MmapPopulationStore(path)
    assert back.meta == json.loads((path / "meta.json").read_text())
    for k, v in back.device_arrays().items():
        np.testing.assert_array_equal(v, data[k])
    ids = _ids(30, seed=2)
    np.testing.assert_array_equal(back.gather(ids), data["examples"][ids])


def _sha256_tree(path: Path):
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(path.iterdir())}


@pytest.mark.parametrize("flags", [
    ["--n-users", "40", "--vocab", "300", "--shard-users", "16"],
    ["--n-users", "12", "--vocab", "500", "--seq-len", "8",
     "--sentences-per-user", "5", "--seed", "3", "--replicate", "50",
     "--shard-users", "32"]], ids=["plain", "replicated"])
def test_build_corpus_writes_the_reference_tools_files(tmp_path, flags,
                                                       monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "ref_build_corpus", ROOT / "tools" / "build_corpus.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["build_corpus.py", "--out",
                                      str(tmp_path / "ref"), *flags])
    tool.main()
    build_corpus.main(["--out", str(tmp_path / "port"), *flags])
    ref, port = _sha256_tree(tmp_path / "ref"), _sha256_tree(tmp_path / "port")
    assert len(ref) >= 4 and ref == port


def test_build_corpus_bakes_canaries_in(tmp_path, capsys, monkeypatch):
    # two canaries on three devices instead of the paper's 27 on 189
    monkeypatch.setattr(build_corpus, "make_canaries", lambda g, vocab:
                        make_canaries(g, vocab, grid=((1, 3), (2, 1)),
                                      per_config=1))
    path = build_corpus.main(["--out", str(tmp_path / "c"), "--n-users",
                              "10", "--vocab", "300", "--inject-canaries"])
    assert "2 canaries" in capsys.readouterr().out
    store = pstore.MmapPopulationStore(path)
    canaries = json.loads((path / "canaries.json").read_text())
    assert [(c["n_u"], c["n_e"]) for c in canaries] == [(1, 3), (2, 1)]
    assert store.n_users == 13
    assert store.synthetic[10:].all() and not store.synthetic[:10].any()
    assert store.emax == 200 and store.counts[10] == 200


def test_store_validation_and_normalization(arrays, tmp_path):
    ds, data = arrays
    with pytest.raises(ValueError, match="no examples"):
        pstore.InMemoryPopulationStore(data["examples"],
                                       np.zeros(30, np.int32),
                                       data["synthetic"])
    with pytest.raises(ValueError, match="E_max"):
        pstore.InMemoryPopulationStore(data["examples"][0], data["counts"],
                                       data["synthetic"])
    with pytest.raises(FileNotFoundError, match="build_corpus"):
        pstore.MmapPopulationStore(tmp_path)
    path = pstore.write_population_store(
        tmp_path / "v", pstore.as_population_store(data), shard_users=64)
    meta = json.loads((path / "meta.json").read_text())
    (path / "meta.json").write_text(json.dumps(dict(meta, version=2)))
    with pytest.raises(ValueError, match="version"):
        pstore.MmapPopulationStore(path)
    (path / "meta.json").write_text(json.dumps(dict(meta, n_shards=3)))
    with pytest.raises(ValueError, match="corrupt"):
        pstore.MmapPopulationStore(path)
    (path / "meta.json").write_text(json.dumps(meta))
    assert isinstance(pstore.as_population_store(str(path)),
                      pstore.MmapPopulationStore)
    mem = pstore.as_population_store(data)
    assert pstore.as_population_store(mem) is mem
    with pytest.raises(TypeError, match="PopulationStore"):
        pstore.as_population_store(3)
    with pytest.raises(ValueError, match="shard_users"):
        pstore.write_population_store(tmp_path / "x", mem, shard_users=0)
