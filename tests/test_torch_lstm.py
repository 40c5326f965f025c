"""The port's CIFG-LSTM (`repro_torch.models.lstm`) against the JAX model
(`repro.models.lstm`, ``cell_path="seq"``) on the same parameters, carried
across by `repro_torch.utils.params.from_jax_params`: ``forward``, both
prefills and ``decode_step``, in float32 and bfloat16, at small widths and
at the full ``gboard-cifg-lstm`` width. Also the port's own contracts: the
length-padded prefill is bitwise the exact one, every cell path agrees on
the CPU, init statistics, the parameter bridge, and device resolution.

Tolerances: float32 logits, h and c within atol 1e-5 / rtol 1e-4 (the two
frameworks order their float32 sums differently); bfloat16 within atol 3e-2
(a one-ulp difference in a float32 sum can flip a bfloat16 rounding).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models.layers import pad_vocab
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import (from_jax_params, to_numpy,
                                      with_compute_copies)

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}
SMALL = dict(vocab=300, d_model=32, d_ff=64)
FULL = {}  # gboard-cifg-lstm as published: vocab 10000, d 96, H 256


def _pair(dtype, widths, seed=0):
    """(jax model, jax params, port model, port params) on one config."""
    jcfg = jax_get_config("gboard-cifg-lstm").with_(
        cell_path="seq", compute_dtype=dtype, **widths)
    pcfg = get_config("gboard-cifg-lstm").with_(compute_dtype=dtype, **widths)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    pm = build(pcfg)
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _tokens(B, S, vocab, seed=1):
    return np.random.default_rng(seed).integers(
        4, vocab, size=(B, S)).astype(np.int32)


def _close(a, b, dtype, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what,
                               **TOL[dtype])


CASES = [pytest.param("float32", SMALL, id="f32-small"),
         pytest.param("bfloat16", SMALL, id="bf16-small"),
         pytest.param("float32", FULL, id="f32-full"),
         pytest.param("bfloat16", FULL, id="bf16-full")]


@pytest.mark.parametrize("dtype,widths", CASES)
def test_forward_matches_jax(dtype, widths):
    jm, jp, pm, pp = _pair(dtype, widths)
    toks = _tokens(3, 7, pm.cfg.vocab)
    lj, (hj, cj) = jm.forward(jp, {"tokens": toks}, collect_cache=True)
    lp, (hp, cp) = pm.forward(pp, {"tokens": toks}, collect_cache=True)
    assert lp.shape == (3, 7, pad_vocab(pm.cfg.vocab))
    _close(lp, lj, dtype, "logits")
    _close(hp, hj, dtype, "h")
    _close(cp, cj, dtype, "c")


@pytest.mark.parametrize("dtype,widths", CASES)
@pytest.mark.parametrize("padded", [False, True], ids=["exact", "length"])
def test_prefill_matches_jax(dtype, widths, padded):
    jm, jp, pm, pp = _pair(dtype, widths)
    toks = _tokens(4, 8, pm.cfg.vocab, seed=2)
    batch = {"tokens": toks}
    if padded:
        batch["length"] = np.array([8, 1, 5, 3], np.int32)
    lj, cj = jm.prefill(jp, batch)
    lp, cp = pm.prefill(pp, batch)
    _close(lp, lj, dtype, "logits")
    for k in ("h", "c"):
        _close(cp[k], cj[k], dtype, k)
    np.testing.assert_array_equal(cp["pos"].numpy(), np.asarray(cj["pos"]))


@pytest.mark.parametrize("dtype,widths", CASES)
def test_decode_steps_match_jax(dtype, widths):
    jm, jp, pm, pp = _pair(dtype, widths)
    toks = _tokens(2, 4, pm.cfg.vocab, seed=3)
    _, jc = jm.prefill(jp, {"tokens": toks})
    _, pc = pm.prefill(pp, {"tokens": toks})
    nxt = _tokens(4, 2, pm.cfg.vocab, seed=4)
    for t in range(4):
        lj, jc = jm.decode_step(jp, nxt[t], jc)
        lp, pc = pm.decode_step(pp, torch.from_numpy(nxt[t]), pc)
        _close(lp, lj, dtype, f"logits step {t}")
        _close(pc["h"], jc["h"], dtype, f"h step {t}")
        _close(pc["c"], jc["c"], dtype, f"c step {t}")
        np.testing.assert_array_equal(pc["pos"].numpy(),
                                      np.asarray(jc["pos"]))


@pytest.mark.parametrize("cell_path", ["auto", "fused", "seq", "ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_length_prefill_is_bitwise_the_exact_prefill(cell_path, dtype):
    cfg = get_config("gboard-cifg-lstm").with_(
        cell_path=cell_path, compute_dtype=dtype, **SMALL)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    toks = _tokens(1, 8, cfg.vocab, seed=5)
    for L in range(1, 9):
        lg_e, c_e = model.prefill(params, {"tokens": toks[:, :L]})
        lg_p, c_p = model.prefill(params, {"tokens": toks,
                                           "length": np.array([L])})
        assert torch.equal(lg_e, lg_p), L
        for k in ("h", "c", "pos"):
            assert torch.equal(c_e[k], c_p[k]), (L, k)


def test_prefill_rejects_bad_lengths():
    cfg = get_config("gboard-cifg-lstm").with_(**SMALL)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(2, 4, cfg.vocab)
    for bad in ([0, 2], [1, 5], [1]):
        with pytest.raises(ValueError, match="length"):
            model.prefill(params, {"tokens": toks, "length": np.array(bad)})


def test_cell_paths_agree_on_cpu():
    """On CPU tensors every cell path is the plain cell: identical bits."""
    base = get_config("gboard-cifg-lstm").with_(**SMALL)
    params = build(base).init(torch.Generator().manual_seed(6),
                              device="cpu")
    toks = _tokens(2, 6, base.vocab, seed=6)
    outs = [build(base.with_(cell_path=p)).forward(params, {"tokens": toks})
            for p in ("auto", "fused", "seq", "ref")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_build_rejects_unknown_cell_path():
    with pytest.raises(ValueError, match="cell_path"):
        build(get_config("gboard-cifg-lstm").with_(cell_path="pallas"))


def test_config_matches_reference():
    ours = get_config("gboard-cifg-lstm")
    theirs = jax_get_config("gboard-cifg-lstm")
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == \
        dataclasses.asdict(theirs.reduced())
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("granite-3-2b")


def test_init_shapes_and_statistics():
    cfg = get_config("gboard-cifg-lstm")
    model = build(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build(jax_get_config("gboard-cifg-lstm")).init,
                       jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: a.shape, to_numpy(p)) == jshapes
    d, h = cfg.d_model, cfg.d_ff
    # truncated at ±2σ, the std is 0.8796σ
    for name, fan_in in (("w_x", d + h), ("w_h", d + h), ("w_proj", h)):
        w = p[name]
        assert abs(float(w.std()) / (0.8796 / fan_in ** 0.5) - 1) < 0.03
        assert float(w.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6
    assert abs(float(p["embed"]["tok"].std()) / 0.02 - 1) < 0.02
    assert float(p["b_gates"].abs().max()) == 0.0
    again = model.init(torch.Generator().manual_seed(0), device="cpu")
    other = model.init(torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(again["w_h"], p["w_h"])
    assert not torch.equal(other["w_h"], p["w_h"])
    assert p["compute"]["w_h"].dtype == torch.bfloat16


def test_params_bridge_round_trip():
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(**SMALL))
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    copies = build(get_config("gboard-cifg-lstm").with_(**SMALL)).compute_copies
    pp = from_jax_params(tree, copies, device="cpu", compute_dtype="bfloat16")
    back = to_numpy(pp)
    assert back.keys() == tree.keys()
    for k in ("w_x", "w_h", "b_gates", "w_proj"):
        np.testing.assert_array_equal(back[k], tree[k])
    np.testing.assert_array_equal(back["embed"]["tok"], tree["embed"]["tok"])
    cw = pp["compute"]
    assert cw["w_h"].dtype == torch.bfloat16
    assert torch.equal(cw["w_x"], pp["w_x"].to(torch.bfloat16).float())
    assert with_compute_copies(pp, "bfloat16", copies) is pp   # made once
    f32 = with_compute_copies(pp, "float32", copies)
    assert f32["compute"]["w_h"].dtype == torch.float32


def test_pad_vocab():
    assert pad_vocab(10_000) == 10_240
    assert pad_vocab(256) == 256 and pad_vocab(257) == 512


def test_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    model = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        model.init_cache(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        from_jax_params({"w_h": np.zeros((2, 6), np.float32)},
                        model.compute_copies)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        resolve_device("meta")
