"""The port's dense transformer (`repro_torch.models.transformer`) at its
``reduced()`` widths against the JAX model on the same parameters, drawn by
the reference's ``init(PRNGKey(0))`` and carried across by
`repro_torch.utils.params.from_jax_params`: forward logits, the prefill's
last logits and its cache (with ``max_len`` > S), three decode steps after
it, and greedy ``generate``. granite-3-2b has a tied head, phi3-mini-3.8b an
untied one; ``attn_window=4`` (the reference's sliding-window setting) runs
the ring cache, decoding past the window. On the CPU the attention is the
plain `layers.attention`, the flash kernel's CPU path.

Also the six decoder configs and their parameter trees against the
reference's, the ring helpers, the attention block alone, and the serving
CLI of both families against the reference's ``generate`` on the CLI's own
weights carried the other way (`to_numpy`).

Tolerances, as a max abs error over the largest reference logit: float32
1e-5 (the frameworks order float32 sums differently), bfloat16 2e-2 (as
``tests/test_models.py``: the two round at different places); cache
leaves: float32 1e-5 of the largest entry, bfloat16 5e-2 (a K or V entry is
a bf16 rounding of a sum that can differ in its last bit, one bf16 ulp is
2**-8 of it).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import generate as jax_generate
from repro.models import build as jax_build
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.utils.params import from_jax_params, to_numpy

DECODER_ARCHS = ("granite-3-2b", "phi3-mini-3.8b", "phi3-medium-14b",
                 "stablelm-12b", "granite-moe-3b-a800m", "olmoe-1b-7b")
# (arch, attn_window): tied head, untied head, the ring cache
VARIANTS = (("granite-3-2b", 0), ("phi3-mini-3.8b", 0), ("granite-3-2b", 4))
DTYPES = ("float32", "bfloat16")
S = 16
EXTRA = 8           # max_len - S: KV slots the decode steps write into
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_CACHE = {"float32": 1e-5, "bfloat16": 5e-2}


def _cfgs(arch, dtype, window):
    kw = dict(compute_dtype=dtype, attn_window=window)
    return (jax_get_config(arch).reduced().with_(**kw),
            get_config(arch).reduced().with_(**kw))


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype, window=0):
    """(jax model, jax params, port model, port params) on one config."""
    jcfg, cfg = _cfgs(arch, dtype, window)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build(cfg)
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype, window):
    """The reference's forward logits, prefill (last logits and cache) with
    max_len = S + EXTRA, and three decode steps after it."""
    jm, jp, _, _ = _pair(arch, dtype, window)
    toks = _tokens((2, S), jm.cfg.vocab, S)
    nxt = _tokens((3, 2), jm.cfg.vocab, S + 1)
    logits = np.asarray(jm.forward(jp, {"tokens": toks}), np.float32)
    last, cache = jm.prefill(jp, {"tokens": toks}, max_len=S + EXTRA)
    prefill = (np.asarray(last, np.float32),
               {k: np.asarray(v, np.float32) for k, v in cache.items()})
    steps = []
    for t in range(3):
        lg, cache = jm.decode_step(jp, jnp.asarray(nxt[t]), cache)
        steps.append(np.asarray(lg, np.float32))
    final = {k: np.asarray(v, np.float32) for k, v in cache.items()}
    return toks, nxt, logits, prefill, steps, final


def _close(got, want, tol, scale=None, what=""):
    """max |got − want| <= tol · scale (default: the largest |want|)."""
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


CASES = [pytest.param(a, d, w, id=f"{a}-w{w}-{d}")
         for a, w in VARIANTS for d in DTYPES]


@pytest.mark.parametrize("arch,dtype,window", CASES)
def test_forward_matches_jax(arch, dtype, window):
    _, _, pm, pp = _pair(arch, dtype, window)
    toks, _, logits, _, _, _ = _jax_run(arch, dtype, window)
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, logits, TOL[dtype], what="logits")


@pytest.mark.parametrize("arch,dtype,window", CASES)
def test_prefill_and_cache_match_jax(arch, dtype, window):
    _, _, pm, pp = _pair(arch, dtype, window)
    toks, _, logits, (last, cache), _, _ = _jax_run(arch, dtype, window)
    got_last, got = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                               max_len=S + EXTRA)
    _close(got_last, last, TOL[dtype], scale=float(np.abs(logits).max()),
           what="last logits")
    assert sorted(got) == sorted(cache) == ["k", "pos", "v"]
    for k, want in cache.items():
        _close(got[k], want, TOL_CACHE[dtype], what=k)
    assert got["k"].dtype == getattr(torch, dtype)
    assert got["k"].shape[2] == (window or S + EXTRA)


@pytest.mark.parametrize("arch,dtype,window", CASES)
def test_decode_steps_match_jax(arch, dtype, window):
    """Three steps after the prefill; with window 4 the ring wraps past
    the window. The cache is written in place."""
    _, _, pm, pp = _pair(arch, dtype, window)
    toks, nxt, logits, _, steps, final = _jax_run(arch, dtype, window)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                          max_len=S + EXTRA)
    k_buf = cache["k"]
    scale = float(np.abs(logits).max())
    for t in range(3):
        lg, cache = pm.decode_step(pp, torch.from_numpy(nxt[t]), cache)
        _close(lg, steps[t], TOL[dtype], scale=scale,
               what=f"decode step {t}")
    assert cache["k"] is k_buf
    for k, want in final.items():
        _close(cache[k], want, TOL_CACHE[dtype],
               what=f"cache {k} after 3 steps")
    assert int(cache["pos"]) == S + 3


@pytest.mark.parametrize("arch,window", VARIANTS)
def test_greedy_generate_matches_jax(arch, window):
    jm, jp, pm, pp = _pair(arch, "float32", window)
    prompts = _tokens((2, S), jm.cfg.vocab, S + 2)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), 6))
    got = generate(pm, pp, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_clamps_the_write_past_the_cache():
    """A full cache: the reference's dynamic_update_slice clamps the write
    to the last slot, and so does the port's in-place write."""
    jm, jp, pm, pp = _pair("granite-3-2b", "float32")
    toks = _tokens((2, S), jm.cfg.vocab, 3)
    _, jc = jm.prefill(jp, {"tokens": toks}, max_len=S)
    _, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)}, max_len=S)
    for t in (5, 6):
        jl, jc = jm.decode_step(jp, jnp.asarray([t, t + 1], jnp.int32), jc)
        tl, tc = pm.decode_step(pp, torch.tensor([t, t + 1]), tc)
        _close(tl, jl, TOL["float32"], what=f"step past the cache {t}")
    _close(tc["k"], jc["k"], TOL_CACHE["float32"], what="k")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("window", [0, 4])
def test_attention_block_matches_jax(dtype, window):
    """`_attn_block` on the CPU (plain attention) against the reference's:
    the residual output and the (k, v) the cache takes."""
    jm, jp, pm, pp = _pair("granite-3-2b", dtype)
    cd = getattr(torch, dtype)
    x = np.random.default_rng(9).standard_normal(
        (2, S, jm.cfg.d_model)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    pos = np.arange(S, dtype=np.int32)
    jcfg = jm.cfg.with_(attn_window=window)
    jx, (jk, jv) = JT._attn_block(jnp.asarray(x, jcfg.compute_dtype), jlp,
                                  jcfg, jnp.asarray(pos), window=window)
    tx, (tk, tv) = T._attn_block(torch.from_numpy(x).to(cd),
                                 L.unstack_layers(pp["compute"]["layers"])[1],
                                 pm.cfg.with_(attn_window=window),
                                 torch.from_numpy(pos), window=window)
    assert tx.dtype == cd
    for got, want, what in ((tx, jx, "x"), (tk, jk, "k"), (tv, jv, "v")):
        _close(got, want, TOL_CACHE[dtype], what=what)


def test_ring_helpers_match_jax():
    for pos in (0, 3, 4, 9, 17):
        np.testing.assert_array_equal(
            L.ring_positions(torch.tensor(pos, dtype=torch.int32), 4).numpy(),
            np.asarray(JL.ring_positions(jnp.asarray(pos, jnp.int32), 4)))
    kv = np.arange(2 * 3 * 11 * 2).reshape(2, 3, 11, 2).astype(np.float32)
    for W in (4, 11, 16):
        np.testing.assert_array_equal(
            L.ring_pack(torch.from_numpy(kv), W).numpy(),
            np.asarray(JL.ring_pack(jnp.asarray(kv), W)))


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_configs_and_trees_match_the_reference(arch):
    """The config and its reduced() field for field; the port's own init
    gives the reference's tree and shapes; the registries build it."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    model = build(cfg.reduced())
    assert model.cfg == cfg.reduced()
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build(ref.reduced()).init, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  to_numpy(p)) == jshapes
    wq = p["layers"]["attn"]["wq"]
    d = cfg.reduced().d_model
    # truncated at ±2σ, the std is 0.8796σ; the layers differ
    assert abs(float(wq.std()) / (0.8796 / d ** 0.5) - 1) < 0.05
    assert not torch.equal(wq[0], wq[1])
    assert ("head" in p["embed"]) == (not cfg.tie_embeddings)


@pytest.mark.parametrize("arch", ["granite-3-2b", "olmoe-1b-7b"])
def test_serving_cli_matches_the_reference(arch, capsys):
    """The CLI's commands of the slice, in process: greedy tokens equal the
    reference's generate on the CLI's own weights and prompts."""
    argv = ["--arch", arch, "--reduced", "--reference", "--device", "cpu",
            "--steps", "4"]
    serve_cli.main(argv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "continuation" in ln]
    assert len(lines) == 4
    got = [eval(ln.split("continuation:")[1]) for ln in lines]
    cfg = get_config(arch).reduced()
    params = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = np.full((4, 4), serve_cli.BOS, np.int32)
    prompts[:, 1:] = np.random.default_rng(1).integers(4, cfg.vocab, (4, 3))
    jm = jax_build(jax_get_config(arch).reduced())
    want = np.asarray(jax_generate(jm, to_numpy(params),
                                   jnp.asarray(prompts), 4))
    assert [row[4:].tolist() for row in want] == got
    if not torch.cuda.is_available():   # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            serve_cli.main(argv[:4] + argv[6:])
