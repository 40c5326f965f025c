"""The port's serving path (`repro_torch.serve`): the continuous-batching
engine against the port's single-session reference token for token (greedy,
seeded temperature, interleaved admission, hot-swap from params and from a
checkpoint the JAX package wrote), bucketed admission, TTL eviction,
``steps=0``, validation; greedy generation and top-k against the JAX
package's ``reference_generate`` in float32; the sampler's contract; the
checkpoint reader; the CLI; and that the port imports neither JAX nor the
JAX package.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.serve import reference_generate as jax_reference_generate
from repro.train import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.serve import (NwpRequest, ServeEngine, reference_generate,
                               validate_cache_layout)
from repro_torch.serve import sampling
from repro_torch.serve.frontend import make_session_key
from repro_torch.train import checkpoint
from repro_torch.utils.params import from_jax_params, to_numpy

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(vocab=300, d_model=32, d_ff=64)


@pytest.fixture(scope="module")
def lstm():
    model = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(scope="module")
def params_b(lstm):
    model, _ = lstm
    return model.init(torch.Generator().manual_seed(42), device="cpu")


def _requests(rng, n, vocab=300, temperature=0.0, seed0=100):
    return [NwpRequest(
        prompt=tuple(int(t) for t in rng.integers(4, vocab,
                                                  size=int(rng.integers(2, 7)))),
        steps=int(rng.integers(1, 7)), temperature=temperature,
        seed=seed0 + i if temperature > 0 else None) for i in range(n)]


def _assert_matches_reference(model, params, engine, reqs, sids, top_k=3):
    for req, sid in zip(reqs, sids):
        res = engine.result(sid)
        toks, cands = reference_generate(
            model, params, req.prompt, req.steps,
            temperature=req.temperature, seed=req.seed, top_k=top_k)
        assert res.tokens == toks, sid
        np.testing.assert_array_equal(res.candidates, cands)


# ------------------------------------------------------- engine vs reference


def test_engine_matches_reference_greedy(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=2, top_k=3)
    assert eng.bucketed_admission
    reqs = _requests(np.random.default_rng(0), 6)
    sids = [eng.submit(r) for r in reqs]
    res = eng.run()
    assert len(res) == 6 and all(r.status == "done" for r in res.values())
    _assert_matches_reference(model, params, eng, reqs, sids)


def test_engine_matches_reference_temperature(lstm):
    model, params = lstm
    reqs = _requests(np.random.default_rng(1), 5, temperature=0.8)
    outs = []
    for _ in range(2):  # a second run gives the same tokens
        eng = ServeEngine(model, params, max_slots=3, top_k=3)
        sids = [eng.submit(r) for r in reqs]
        eng.run()
        _assert_matches_reference(model, params, eng, reqs, sids)
        outs.append([eng.result(s).tokens for s in sids])
    assert outs[0] == outs[1]
    eng = ServeEngine(model, params, max_slots=2, top_k=3)
    a = eng.submit(NwpRequest(prompt=(2, 5, 9), steps=8, temperature=0.9,
                              seed=7))
    b = eng.submit(NwpRequest(prompt=(2, 5, 9), steps=8, temperature=0.9,
                              seed=8))
    eng.run()
    assert eng.result(a).tokens != eng.result(b).tokens


def test_interleaved_admission_parity(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=3, top_k=3)
    rng = np.random.default_rng(2)
    first = _requests(rng, 3, temperature=0.6, seed0=200)
    sids = [eng.submit(r) for r in first]
    eng.step()
    eng.step()
    late = _requests(rng, 4, temperature=0.6, seed0=300)
    sids += [eng.submit(r) for r in late]
    eng.step()
    more = _requests(rng, 2)
    sids += [eng.submit(r) for r in more]
    eng.run()
    _assert_matches_reference(model, params, eng, first + late + more, sids)


def test_fifo_admission_and_slot_reuse(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=1, top_k=2)
    reqs = [NwpRequest(prompt=(2, 10 + i), steps=3) for i in range(4)]
    sids = [eng.submit(r) for r in reqs]
    eng.run()
    admits = [eng.result(s).admit_tick for s in sids]
    assert admits == sorted(admits)
    _assert_matches_reference(model, params, eng, reqs, sids, top_k=2)


def test_topk_candidates_shape_and_ordering(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=2, top_k=4)
    sid = eng.submit(NwpRequest(prompt=(2, 5, 9), steps=5))
    narrow = eng.submit(NwpRequest(prompt=(2, 5, 9), steps=5, top_k=2))
    eng.run()
    res = eng.result(sid)
    assert res.candidates.shape == (5, 4)
    np.testing.assert_array_equal(res.candidates[:, 0], np.asarray(res.tokens))
    assert all(len(set(row)) == 4 for row in res.candidates)
    _, ref_cands = reference_generate(model, params, (2, 5, 9), 5, top_k=4)
    np.testing.assert_array_equal(res.candidates, ref_cands)
    np.testing.assert_array_equal(eng.result(narrow).candidates,
                                  ref_cands[:, :2])


def test_hot_swap_atomicity_and_parity(lstm, params_b):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=4, top_k=3)
    reqs = [NwpRequest(prompt=(2, 5, 9 + i), steps=8,
                       temperature=0.7 if i % 2 else 0.0,
                       seed=50 + i if i % 2 else None) for i in range(4)]
    sids = [eng.submit(r) for r in reqs]
    for _ in range(3):
        eng.step()
    assert eng.active_sessions == 4
    assert eng.swap_params(params_b) == 1
    post = NwpRequest(prompt=(2, 77), steps=4)
    post_sid = eng.submit(post)
    eng.run()
    for req, sid in zip(reqs, sids):
        res = eng.result(sid)
        assert res.status == "done"
        vs = res.params_versions
        assert list(vs) == sorted(vs) and set(vs) <= {0, 1}
        assert vs[0] == 0 and vs[-1] == 1
        toks, cands = reference_generate(
            model, params, req.prompt, req.steps,
            temperature=req.temperature, seed=req.seed, top_k=3,
            swaps=[(vs.index(1), params_b)])
        assert res.tokens == toks
        np.testing.assert_array_equal(res.candidates, cands)
    res = eng.result(post_sid)
    assert set(res.params_versions) == {1}
    toks, _ = reference_generate(model, params, post.prompt, post.steps,
                                 swaps=[(0, params_b)])
    assert res.tokens == toks


def test_hot_swap_from_jax_written_checkpoint(tmp_path, lstm, params_b):
    """The promotion path: a checkpoint file of the JAX package's format is
    read by the port and swapped in without dropping sessions."""
    model, params = lstm
    ck = tmp_path / "round_next.msgpack"
    jax_checkpoint.save(ck, to_numpy(params_b), meta={"arch": "gboard"})
    eng = ServeEngine(model, params, max_slots=2, top_k=3)
    sid = eng.submit(NwpRequest(prompt=(2, 5, 9), steps=6))
    eng.step()
    assert eng.load_checkpoint(ck) == 1
    eng.run()
    res = eng.result(sid)
    assert res.status == "done"
    toks, _ = reference_generate(
        model, params, (2, 5, 9), 6,
        swaps=[(res.params_versions.index(1), params_b)])
    assert res.tokens == toks


def test_ttl_eviction_frees_slot(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=1, top_k=3)
    hog = eng.submit(NwpRequest(prompt=(2, 5), steps=50, ttl_ticks=3))
    nxt = eng.submit(NwpRequest(prompt=(2, 9), steps=2))
    eng.run()
    res = eng.result(hog)
    assert res.status == "evicted" and len(res.tokens) == 4
    assert res.tokens == reference_generate(model, params, (2, 5), 4)[0]
    assert eng.result(nxt).status == "done"
    assert len(eng.result(nxt).tokens) == 2


def test_steps0_completes_immediately(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=2, top_k=3)
    res = eng.result(eng.submit(NwpRequest(prompt=(2, 5, 9), steps=0)))
    assert res.status == "done" and res.tokens == ()
    assert res.candidates.shape == (0, 3) and res.sequence == (2, 5, 9)
    assert eng.in_flight == 0


def test_submit_validation(lstm):
    model, params = lstm
    eng = ServeEngine(model, params, max_slots=2, top_k=3)
    with pytest.raises(ValueError, match="seed"):
        eng.submit(NwpRequest(prompt=(2, 5), steps=3, temperature=0.8))
    with pytest.raises(ValueError, match="steps"):
        eng.submit(NwpRequest(prompt=(2, 5), steps=-1))
    with pytest.raises(ValueError, match="prompt tokens"):
        eng.submit(NwpRequest(prompt=(2, 999), steps=1))
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(NwpRequest(prompt=(), steps=1))
    with pytest.raises(ValueError, match="top_k"):
        eng.submit(NwpRequest(prompt=(2, 5), steps=1, top_k=7))
    with pytest.raises(ValueError, match="ttl"):
        eng.submit(NwpRequest(prompt=(2, 5), steps=1, ttl_ticks=0))
    assert eng.submit(NwpRequest(prompt=(2, 5), steps=0,
                                 session_id="dup")) == "dup"
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(NwpRequest(prompt=(2, 5), steps=1, session_id="dup"))
    eng.submit(NwpRequest(prompt=(2, 5), steps=1, session_id="waiting"))
    with pytest.raises(ValueError, match="duplicate"):   # still queued
        eng.submit(NwpRequest(prompt=(2, 6), steps=1, session_id="waiting"))


def test_engine_constructor_and_swap_validation(lstm):
    model, params = lstm
    with pytest.raises(ValueError, match="max_slots"):
        ServeEngine(model, params, max_slots=0)
    with pytest.raises(ValueError, match="top_k"):
        ServeEngine(model, params, max_slots=2, top_k=0)
    eng = ServeEngine(model, params, max_slots=2)
    meta = {k: (v.to("meta") if not isinstance(v, dict) else v)
            for k, v in params.items()}
    with pytest.raises(ValueError, match="serves on"):
        eng.swap_params(meta)
    wider = build(get_config("gboard-cifg-lstm").with_(
        vocab=300, d_model=32, d_ff=96)).init(
        torch.Generator().manual_seed(1), device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        eng.swap_params(wider)
    assert eng.params_version == 0


def test_cache_layout_contract(lstm):
    model, _ = lstm
    cache = validate_cache_layout(model, max_slots=4, max_len=16,
                                  device="cpu")
    assert all(v.shape[0] == 4 for v in cache.values())
    shared = model._replace(init_cache=lambda b, n, device=None: {
        "k": torch.zeros(b, 2), "pos": torch.zeros(())})
    with pytest.raises(ValueError, match="continuous-batching"):
        validate_cache_layout(shared, max_slots=4, max_len=16)


def test_cache_layout_contract_rejected(lstm):
    """The reference's test of the same name: a KV model shares a scalar
    position and leads its cache with the layer axis, so the engine must
    refuse it with a clear error, not corrupt slots."""
    model = build(get_config("granite-3-2b").reduced())
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="continuous-batching"):
        validate_cache_layout(model, max_slots=4, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="per-row"):
        ServeEngine(model, params, max_slots=4)
    # the paper's model passes the same validation the engine runs
    lstm_model, _ = lstm
    cache = validate_cache_layout(lstm_model, max_slots=4, max_len=16,
                                  device="cpu")
    assert all(leaf.shape[0] == 4 for leaf in cache.values())


def test_probe_falls_back_when_length_is_ignored(lstm):
    """A prefill that ignores ``length`` fails the bitwise probe; the engine
    admits at exact length and still matches the reference."""
    model, params = lstm

    def ignore_length(p, batch, **kw):
        return model.prefill(p, {"tokens": batch["tokens"]}, **kw)

    naive = model._replace(prefill=ignore_length)
    eng = ServeEngine(naive, params, max_slots=2)
    assert not eng.bucketed_admission
    reqs = _requests(np.random.default_rng(3), 3)
    sids = [eng.submit(r) for r in reqs]
    eng.run()
    _assert_matches_reference(model, params, eng, reqs, sids)
    assert len(eng.admission_times_s) == 3


# ------------------------------------------------------ against the JAX path


@pytest.mark.parametrize("prompt,steps", [((2, 17, 33), 6), ((2,), 4),
                                          ((2, 5, 9, 11, 80, 123, 7), 5)])
def test_greedy_generation_matches_jax(prompt, steps):
    jcfg = jax_get_config("gboard-cifg-lstm").with_(
        compute_dtype="float32", **SMALL)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(7))
    pm = build(get_config("gboard-cifg-lstm").with_(compute_dtype="float32",
                                                    **SMALL))
    pp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         pm.compute_copies, device="cpu",
                         compute_dtype="float32")
    jt, jc = jax_reference_generate(jm, jp, prompt, steps, top_k=3)
    pt, pc = reference_generate(pm, pp, prompt, steps, top_k=3)
    assert pt == jt
    np.testing.assert_array_equal(pc, jc)


# --------------------------------------------------------------- sampling


def test_sampling_is_independent_of_batch_and_row():
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((5, 50)).astype(np.float32))
    keys = torch.tensor(np.stack([make_session_key(s) for s in range(5)])
                        .astype(np.int64))
    ts = torch.tensor([0, 3, 1, 9, 2])
    temps = torch.tensor([0.0, 0.7, 1.3, 0.0, 0.9])
    batch = sampling.sample_tokens(logits, keys, ts, temps)
    for r in range(5):
        one = sampling.sample_tokens(logits[r:r + 1], keys[r:r + 1],
                                     ts[r:r + 1], temps[r:r + 1])
        assert int(one[0]) == int(batch[r])
    perm = torch.tensor([3, 0, 4, 1, 2])
    shuffled = sampling.sample_tokens(logits[perm], keys[perm], ts[perm],
                                      temps[perm])
    assert torch.equal(shuffled, batch[perm])
    assert int(batch[0]) == int(torch.argmax(logits[0]))


def test_sampling_follows_the_softmax():
    """Frequencies over 20000 draws (distinct step indices) match
    softmax(logits / T) within 4 binomial standard deviations."""
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0, 0.5]])
    T, n = 0.8, 20000
    keys = torch.tensor(make_session_key(11)[None].astype(np.int64))
    draws = sampling.sample_tokens(logits.expand(n, -1), keys.expand(n, -1),
                                   torch.arange(n), torch.full((n,), T))
    freq = torch.bincount(draws.long(), minlength=5).double() / n
    p = torch.softmax(logits[0].double() / T, 0)
    assert torch.all((freq - p).abs() <= 4 * (p * (1 - p) / n).sqrt())


def test_ties_rank_toward_the_lower_index():
    logits = torch.tensor([[0.0, 3.0, 1.0, 3.0, 1.0, 3.0]])
    np.testing.assert_array_equal(sampling.topk_ids(logits, 4).numpy(),
                                  [[1, 3, 5, 2]])
    greedy = sampling.sample_tokens(logits, torch.zeros(1, 2, dtype=torch.long),
                                    torch.zeros(1), torch.zeros(1))
    assert int(greedy[0]) == 1


def test_hash_is_a_32_bit_mix():
    x = torch.arange(4096, dtype=torch.int64)
    h = sampling.hash32(x)
    assert int(h.min()) >= 0 and int(h.max()) < 2 ** 32
    assert len(set(h.tolist())) == 4096           # a bijection on 32 bits
    ref = []
    for v in x.tolist():  # the same mixer in Python integers
        v ^= v >> 16
        v = (v * 0x7FEB352D) & 0xFFFFFFFF
        v ^= v >> 15
        v = (v * 0x846CA68B) & 0xFFFFFFFF
        ref.append(v ^ (v >> 16))
    assert h.tolist() == ref


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1])
def test_session_key_words_are_those_of_prngkey(seed):
    np.testing.assert_array_equal(
        make_session_key(seed), np.asarray(jax.random.PRNGKey(seed),
                                           np.uint32))
    assert not make_session_key(None).any()


def test_generate_batch_path(lstm):
    model, params = lstm
    prompts = np.array([[2, 5, 9], [2, 7, 11]])
    assert torch.equal(generate(model, params, prompts, 0),
                       torch.as_tensor(prompts))
    with pytest.raises(ValueError, match="seed"):
        generate(model, params, prompts, 3, temperature=0.5)
    out = generate(model, params, prompts, 4)
    assert out.shape == (2, 7)
    for row, p in zip(out.tolist(), prompts.tolist()):
        assert tuple(row[3:]) == reference_generate(model, params, p, 4)[0]
    hot = generate(model, params, np.array([[2, 5, 9]] * 2), 6,
                   temperature=1.0, seed=3)
    assert hot[0].tolist() != hot[1].tolist()   # rows draw their own streams


# ------------------------------------------------------------ checkpoints


def test_checkpoint_reader_reads_jax_checkpoints(tmp_path):
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**SMALL))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    ck = tmp_path / "p.msgpack"
    jax_checkpoint.save(ck, tree, meta={"round": 7, "arch": "x"})
    got, meta = checkpoint.load(ck)
    assert meta == {"round": 7, "arch": "x"}
    for k in ("w_x", "w_h", "b_gates", "w_proj"):
        np.testing.assert_array_equal(got[k], tree[k])
    np.testing.assert_array_equal(got["embed"]["tok"], tree["embed"]["tok"])
    # a pre-split checkpoint (fused w_gates) is migrated on load
    old = dict(tree)
    old["w_gates"] = np.concatenate([old.pop("w_x"), old.pop("w_h")])
    jax_checkpoint.save(tmp_path / "old.msgpack", old)
    got, _ = checkpoint.load(tmp_path / "old.msgpack")
    np.testing.assert_array_equal(got["w_x"], tree["w_x"])
    np.testing.assert_array_equal(got["w_h"], tree["w_h"])
    assert "w_gates" not in got


def test_checkpoint_reader_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.load(tmp_path / "missing.msgpack")
    bad = tmp_path / "bad.msgpack"
    bad.write_bytes(b"\x93not a checkpoint")
    with pytest.raises(checkpoint.CheckpointError, match="corrupt"):
        checkpoint.load(bad)


# ---------------------------------------------------- isolation and the CLI


def _run(code_or_args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_neither_jax_nor_the_jax_package():
    out = _run(["-c", (
        "import sys, repro_torch, repro_torch.serve, "
        "repro_torch.launch.serve, repro_torch.kernels.build\n"
        "bad = [m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(bad)")])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cli_serves_on_cpu_with_a_hot_swap(tmp_path):
    # the CLI serves the published widths with --vocab's vocabulary
    cli_model = build(get_config("gboard-cifg-lstm").with_(vocab=300))
    ck = tmp_path / "swap.msgpack"
    jax_checkpoint.save(ck, to_numpy(cli_model.init(
        torch.Generator().manual_seed(42), device="cpu")))
    out = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                "--vocab", "300", "--batch", "3", "--steps", "4",
                "--temperature", "0.7", "--hot-swap", str(ck)])
    assert out.returncode == 0, out.stderr
    assert "hot-swapped" in out.stdout
    assert out.stdout.count("[done]") == 3
    ref = _run(["-m", "repro_torch.launch.serve", "--device", "cpu",
                "--vocab", "300", "--batch", "2", "--steps", "3",
                "--reference"])
    assert ref.returncode == 0, ref.stderr
    assert ref.stdout.count("continuation") == 2


def test_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")
    out = _run(["-m", "repro_torch.launch.serve", "--batch", "1"])
    assert out.returncode != 0
    assert "no CUDA GPU" in out.stderr
