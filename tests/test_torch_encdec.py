"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper-small)
at its ``reduced()`` widths against the JAX model on the same parameters,
drawn by the reference's ``init(PRNGKey(0))`` and carried across by
`repro_torch.utils.params.from_jax_params`: ``encode``, forward logits,
``loss_fn`` (with and without remat), the prefill's last logits and its
cache, three decode steps after it; the sinusoidal tables; the config,
its tree and the registries. On the CPU every attention is the plain
`layers.attention`, the flash kernel's CPU path.

Tolerances, as a max abs error over the largest reference value: float32
1e-5 (the frameworks order float32 sums differently), bfloat16 2e-2 (the
two round at different places, as ``tests/test_torch_transformer.py``);
cache leaves float32 1e-5, bfloat16 5e-2 of their largest entry; the loss
1e-5 relative in float32; the sinusoidal tables 1e-6 absolute (XLA's and
torch's sin, cos and pow differ in the last ulp).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import encdec as JE
from repro.models import layers as JL
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config
from repro_torch.models import build
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.utils.params import from_jax_params, to_numpy

ARCH = "whisper-small"
DTYPES = ("float32", "bfloat16")
S = 12
EXTRA = 6
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_CACHE = {"float32": 1e-5, "bfloat16": 5e-2}


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    """(jax model, jax params, port model, port params) on one config."""
    jm = jax_build(jax_get_config(ARCH).reduced().with_(compute_dtype=dtype))
    pm = build(get_config(ARCH).reduced().with_(compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _batch(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab, (B, S + 1)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)
                                 ).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:], "frames": frames}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close(got, want, tol, scale=None, what=""):
    """max |got − want| <= tol · scale (default: the largest |want|)."""
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


@functools.lru_cache(maxsize=None)
def _jax_run(dtype):
    """The reference's memory, logits, prefill (max_len = S + EXTRA) and
    three decode steps after it."""
    jm, jp, _, _ = _pair(dtype)
    b = _batch(jm.cfg)
    memory = np.asarray(JE.encode(jp, jnp.asarray(b["frames"]), jm.cfg),
                        np.float32)
    logits = np.asarray(jm.forward(jp, b), np.float32)
    last, cache = jm.prefill(jp, b, max_len=S + EXTRA)
    pre = (np.asarray(last, np.float32),
           {k: np.asarray(v, np.float32) for k, v in cache.items()})
    nxt = np.random.default_rng(1).integers(4, jm.cfg.vocab, (3, 2)
                                            ).astype(np.int32)
    steps = []
    for t in range(3):
        lg, cache = jm.decode_step(jp, jnp.asarray(nxt[t]), cache)
        steps.append(np.asarray(lg, np.float32))
    final = {k: np.asarray(v, np.float32) for k, v in cache.items()}
    return b, memory, logits, pre, nxt, steps, final


@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_matches_jax(dtype):
    _, _, pm, pp = _pair(dtype)
    b, memory, _, _, _, _, _ = _jax_run(dtype)
    got = E.encode(pp, torch.from_numpy(b["frames"]), pm.cfg)
    assert got.dtype == getattr(torch, dtype)
    _close(got, memory, TOL_CACHE[dtype], what="memory")


@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_matches_jax(dtype):
    _, _, pm, pp = _pair(dtype)
    b, _, logits, _, _, _, _ = _jax_run(dtype)
    got = pm.forward(pp, _torch_batch(b))
    assert got.dtype == torch.float32
    _close(got, logits, TOL[dtype], what="logits")


@pytest.mark.parametrize("remat", [True, False])
def test_loss_matches_jax(remat):
    jm, jp, pm, pp = _pair("float32")
    b = _batch(jm.cfg, seed=5)
    want = float(JE.loss_fn(jp, b, jm.cfg, remat=remat))
    got = float(E.loss_fn(pp, _torch_batch(b), pm.cfg, remat=remat))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_and_decode_match_jax(dtype):
    _, _, pm, pp = _pair(dtype)
    b, _, logits, (last, cache), nxt, steps, final = _jax_run(dtype)
    scale = float(np.abs(logits).max())
    got_last, got = pm.prefill(pp, _torch_batch(b), max_len=S + EXTRA)
    _close(got_last, last, TOL[dtype], scale=scale, what="last logits")
    assert sorted(got) == sorted(cache) == ["k", "pos", "v", "xk", "xv"]
    for k, want in cache.items():
        _close(got[k], want, TOL_CACHE[dtype], what=k)
    k_buf = got["k"]
    for t in range(3):
        lg, got = pm.decode_step(pp, torch.from_numpy(nxt[t]), got)
        _close(lg, steps[t], TOL[dtype], scale=scale, what=f"step {t}")
    assert got["k"] is k_buf
    for k, want in final.items():
        _close(got[k], want, TOL_CACHE[dtype], what=f"{k} after 3 steps")
    assert int(got["pos"]) == S + 3


def test_init_cache_matches_jax():
    jm, _, pm, _ = _pair("bfloat16")
    want = jm.init_cache(3, 20)
    got = pm.init_cache(3, 20, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["xk"].dtype == torch.bfloat16


@pytest.mark.parametrize("d", [8, 768])
def test_sinusoidal_tables_match_jax(d):
    want = np.asarray(JL.sinusoidal_positions(40, d))
    got = L.sinusoidal_positions(40, d)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for pos in (0, 7, 39):
        row = L.sinusoidal_position_at(torch.tensor(pos, dtype=torch.int32),
                                       d)
        np.testing.assert_allclose(
            row.numpy(), np.asarray(JL.sinusoidal_position_at(
                jnp.asarray(pos, jnp.int32), d)), rtol=0, atol=1e-6)
        np.testing.assert_allclose(row[0].numpy(), got[pos].numpy(), rtol=0,
                                   atol=1e-6)


def test_config_tree_and_registries_match_the_reference():
    """whisper-small field for field, its reduced(), the port's own init
    against the reference's tree and shapes; the registries' lists."""
    cfg, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    model = build(cfg.reduced())
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build(ref.reduced()).init, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  to_numpy(p)) == jshapes
    wq = p["enc_layers"]["attn"]["wq"]
    assert not torch.equal(wq[0], wq[1])
    from repro.configs import ALL_ARCHS as JALL
    from repro.configs import ASSIGNED_ARCHS as JASSIGNED
    assert ALL_ARCHS == list(JALL) and ASSIGNED_ARCHS == list(JASSIGNED)
    for arch in ALL_ARCHS:
        assert build(get_config(arch).reduced()).cfg.family == \
            jax_get_config(arch).family
