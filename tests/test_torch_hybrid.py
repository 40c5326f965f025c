"""The port's Mamba-2 (`repro_torch.models.mamba2`, ``mamba2-370m``) and
Zamba2 hybrid (`repro_torch.models.hybrid`, ``zamba2-2.7b``) at their
``reduced()`` widths against the JAX models on the same parameters, drawn by
the reference's ``init(PRNGKey(0))`` and carried across by
`repro_torch.utils.params.from_jax_params`: forward logits, the prefill's
last logits and every cache leaf (with ``max_len`` > S), three decode steps
after it, and greedy ``generate`` against the reference's, at S = 16 and at
S = 256 (the SSD state crosses a chunk, attention a 128-block). On the CPU
the port runs the kernels' plain versions.

Also the faults this slice repaired, each with a test that fails on the
commit before it: ``generate`` gives the prefill ``max_len`` (1) and finds
its device from any parameter leaf (2); the parameter bridge carries any
family's tree (3); ``ModelConfig.head_dim`` (4); the registries (5). And the
engine's refusal of both caches, the port's own init, the LSTM's weights
and compute copies unchanged, and the serving CLI's imports.

Tolerances, as a max abs error over the largest reference value: float32
1e-4 (the frameworks order float32 sums differently); bfloat16 2e-2 for
logits (as ``tests/test_models.py``: the two round at different places) and
5e-2 for cache leaves (the reference's own bf16 cache differs from its
float32 one by up to 2.3% of the largest entry, the SSM state at S = 256, so
two bf16 computations can differ by about twice that).
"""
import dataclasses
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import generate as jax_generate
from repro.models import build as jax_build
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.configs import get_config
from repro_torch.launch.serve import generate
from repro_torch.models import build
from repro_torch.serve import ServeEngine
from repro_torch.utils.params import (from_jax_params, param_device,
                                      to_numpy, with_compute_copies)
from repro_torch.utils.pytree import tree_leaves

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("zamba2-2.7b", "mamba2-370m")
DTYPES = ("float32", "bfloat16")
SEQS = (16, 256)
EXTRA = 8           # max_len - S: KV slots the decode steps write into


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    """(jax model, jax params, port model, port params) on one config."""
    jm = jax_build(jax_get_config(arch).reduced().with_(compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    pm = build(get_config(arch).reduced().with_(compute_dtype=dtype))
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, dtype, S):
    """The reference's outputs: forward logits, prefill (last logits and
    cache) with max_len = S + EXTRA, and three decode steps after it."""
    jm, jp, _, _ = _pair(arch, dtype)
    vocab = jm.cfg.vocab
    toks = _tokens((2, S), vocab, S)
    nxt = _tokens((3, 2), vocab, S + 1)
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


TOL = {"float32": 1e-4, "bfloat16": 2e-2}
TOL_CACHE = {"float32": 1e-4, "bfloat16": 5e-2}


def _close(got, want, tol, scale=None, what=""):
    """max |got − want| <= tol · scale (default: the largest |want|)."""
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


CASES = [pytest.param(a, d, s, id=f"{a}-{d}-S{s}")
         for a in ARCHS for d in DTYPES for s in SEQS]


@pytest.mark.parametrize("arch,dtype,S", CASES)
def test_forward_matches_jax(arch, dtype, S):
    _, _, pm, pp = _pair(arch, dtype)
    toks, _, logits, _, _, _ = _jax_run(arch, dtype, S)
    got = pm.forward(pp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _close(got, logits, TOL[dtype], what="logits")


@pytest.mark.parametrize("arch,dtype,S", CASES)
def test_prefill_and_cache_match_jax(arch, dtype, S):
    _, _, pm, pp = _pair(arch, dtype)
    toks, _, logits, (last, cache), _, _ = _jax_run(arch, dtype, S)
    got_last, got = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                               max_len=S + EXTRA)
    _close(got_last, last, TOL[dtype], scale=float(np.abs(logits).max()),
           what="last logits")
    assert sorted(got) == sorted(cache)
    for k, want in cache.items():
        _close(got[k], want, TOL_CACHE[dtype], what=k)
    if "k" in cache:
        assert got["k"].shape[2] == S + EXTRA


@pytest.mark.parametrize("arch,dtype,S", CASES)
def test_decode_steps_match_jax(arch, dtype, S):
    _, _, pm, pp = _pair(arch, dtype)
    toks, nxt, logits, _, steps, final = _jax_run(arch, dtype, S)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                          max_len=S + EXTRA)
    scale = float(np.abs(logits).max())
    for t in range(3):
        lg, cache = pm.decode_step(pp, torch.from_numpy(nxt[t]), cache)
        _close(lg, steps[t], TOL[dtype], scale=scale,
               what=f"decode step {t}")
    for k, want in final.items():
        _close(cache[k], want, TOL_CACHE[dtype],
               what=f"cache {k} after 3 steps")
    assert int(cache["pos"]) == S + 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("S", SEQS)
def test_greedy_generate_matches_jax(arch, S):
    """Fault 1 end to end: the hybrid decodes past the prompt into KV slots
    that exist only when generate passes max_len = S0 + steps."""
    jm, jp, pm, pp = _pair(arch, "float32")
    prompts = _tokens((2, S), jm.cfg.vocab, S + 2)
    want = np.asarray(jax_generate(jm, jp, jnp.asarray(prompts), 6))
    got = generate(pm, pp, torch.from_numpy(prompts), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_passes_max_len_to_prefill():
    """Fault 1: the prefill gets max_len = S0 + steps, as the reference's."""
    _, _, pm, pp = _pair("zamba2-2.7b", "float32")
    seen = {}

    def prefill(params, batch, **kw):
        seen.update(kw)
        return pm.prefill(params, batch, **kw)

    out = generate(pm._replace(prefill=prefill), pp,
                   torch.from_numpy(_tokens((2, 16), 512, 5)), 5)
    assert seen == {"max_len": 21} and out.shape == (2, 21)


def test_generate_sampling_per_row():
    """Rows sample at their own temperature: greedy rows are those of a
    greedy call, and sampling needs a seed."""
    _, _, pm, pp = _pair("mamba2-370m", "float32")
    prompts = torch.from_numpy(_tokens((3, 16), 512, 6))
    greedy = generate(pm, pp, prompts, 5)
    mixed = generate(pm, pp, prompts, 5, temperature=[0.0, 0.9, 0.0], seed=3)
    assert torch.equal(mixed[[0, 2]], greedy[[0, 2]])
    with pytest.raises(ValueError, match="seed"):
        generate(pm, pp, prompts, 5, temperature=[0.0, 0.9, 0.0])


# ----------------------------------------------------------------- faults


def test_params_bridge_round_trips_a_hybrid_tree():
    """Fault 3: from_jax_params and to_numpy carry any family's tree; the
    compute copies are a bf16 mirror of every matrix, made once."""
    jm, _, pm, pp = _pair("zamba2-2.7b", "bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0)))
    back = to_numpy(pp)
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_t] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_t, flat_b):
        np.testing.assert_array_equal(a, b)
    cw = pp["compute"]
    wz = cw["mamba_layers"]["mixer"]["w_z"]
    assert wz.dtype == torch.bfloat16
    assert torch.equal(wz, pp["mamba_layers"]["mixer"]["w_z"].bfloat16())
    assert cw["mamba_layers"]["mixer"]["A_log"] is \
        pp["mamba_layers"]["mixer"]["A_log"]            # vectors as they are
    assert with_compute_copies(pp, "bfloat16", pm.compute_copies) is pp
    f32 = with_compute_copies(pp, "float32", pm.compute_copies)["compute"]
    assert f32["shared_attn"]["attn"]["wq"] is pp["shared_attn"]["attn"]["wq"]
    assert param_device(pp) == torch.device("cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_serving_keeps_the_float32_parts_float32(arch, monkeypatch):
    """In bfloat16 only the matrices are rounded: every vector leaf of the
    compute mirror (A_log, dt_bias, D, norm scales, biases) is the float32
    parameter itself; dt, A and the SSM state reach the scan and the
    recurrence in float32; and every cache leaf has the reference's dtype.
    The bf16 tolerances of the parity tests pass a tree whose vectors were
    rounded, so this test holds the precision itself."""
    from repro_torch.models import mamba2 as M

    jm, jp, pm, pp = _pair(arch, "bfloat16")
    stacked = "mamba_layers" if arch == "zamba2-2.7b" else "layers"
    flat_c = jax.tree_util.tree_flatten_with_path(pp["compute"])[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(
        {k: v for k, v in pp.items() if k != "compute"})[0])
    n_vec = 0
    for path, c in flat_c:
        master = flat_p[path]
        if master.dim() - (path[0].key == stacked) < 2:
            assert c is master and c.dtype == torch.float32, path
            n_vec += 1
        else:
            assert c.dtype == torch.bfloat16, path
            assert torch.equal(c, master.bfloat16()), path
    assert n_vec >= 8

    seen = []
    proj, scan = M._proj, M.ssd_scan

    def spy_proj(x, p):
        out = proj(x, p)
        seen.append(("dt", out[-1].dtype))
        return out

    def spy_scan(xh, dt, Bc, Cc, A):
        seen.append(("scan dt", dt.dtype))
        seen.append(("A", A.dtype))
        return scan(xh, dt, Bc, Cc, A)

    monkeypatch.setattr(M, "_proj", spy_proj)
    monkeypatch.setattr(M, "ssd_scan", spy_scan)
    toks = _tokens((2, 16), jm.cfg.vocab, 5)
    _, cache = pm.prefill(pp, {"tokens": torch.from_numpy(toks).long()},
                          max_len=16 + EXTRA)
    _, jcache = jm.prefill(jp, {"tokens": toks}, max_len=16 + EXTRA)
    want = {k: str(v.dtype) for k, v in jcache.items()}
    assert {k: str(v.dtype).split(".")[-1] for k, v in cache.items()} == want
    _, cache = pm.decode_step(pp, torch.tensor([5, 6]), cache)
    assert {k: str(v.dtype).split(".")[-1] for k, v in cache.items()} == want
    assert want["ssm"] == "float32"
    assert seen and all(dt == torch.float32 for _, dt in seen), seen
    assert {w for w, _ in seen} == {"dt", "scan dt", "A"}


def test_lstm_weights_and_compute_copies_unchanged():
    """The CIFG-LSTM's init for a seed and its compute copies are bitwise
    those of the commit before the per-family copies (digests taken there,
    CPU generator, torch's CPU streams)."""
    want = {"small": "edda45e2efad65157db7f2efc21955a08d72b1a669730a66aa"
                     "397a3b3da4d781",
            "full": "721a0db1769471c845238bbf2aaca1eae221e6b54453e49e4e39"
                    "bb7794d2a648"}
    for name, widths in (("small", dict(vocab=300, d_model=32, d_ff=64)),
                         ("full", {})):
        model = build(get_config("gboard-cifg-lstm").with_(**widths))
        p = model.init(torch.Generator().manual_seed(0), device="cpu")
        assert sorted(p["compute"]) == ["tok", "w_h", "w_proj", "w_x"]
        h = hashlib.sha256()
        for leaf in tree_leaves(p):
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.view(torch.int16)
            h.update(leaf.contiguous().view(torch.uint8).numpy().tobytes())
        assert h.hexdigest() == want[name], name


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_registries(arch):
    """Faults 4 and 5: head_dim, and both registries know the families."""
    cfg = get_config(arch)
    ref = jax_get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.head_dim == ref.head_dim
    assert cfg.reduced().head_dim == ref.reduced().head_dim
    assert build(cfg.reduced()).cfg == cfg.reduced()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_cache_as_the_reference_does(arch):
    """Fault 2 on the engine's side: it finds the device without the LSTM's
    w_h and refuses the layer-leading cache with the reference's error."""
    jm, jp, pm, pp = _pair(arch, "float32")
    with pytest.raises(ValueError) as want:
        JaxServeEngine(jm, jp, max_slots=4)
    with pytest.raises(ValueError) as got:
        ServeEngine(pm, pp, max_slots=4)

    def leaves(msg):
        return sorted(part.split(":")[0].strip() for part in
                      msg.split("offending leaves: ")[1].split(". ")[0]
                      .split(", ") if part.strip().startswith("["))
    head = "is not continuous-batching capable"
    assert head in str(want.value) and head in str(got.value)
    assert leaves(str(got.value)) == leaves(str(want.value))
    tail = str(want.value).split(". ")[-1]
    assert str(got.value).endswith(tail)


def test_mixer_refuses_lengths_the_reference_refuses():
    _, _, pm, pp = _pair("mamba2-370m", "float32")
    with pytest.raises(ValueError, match="not a multiple of the SSD chunk"):
        pm.forward(pp, {"tokens": torch.from_numpy(_tokens((1, 200), 512,
                                                           0))})


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_and_statistics(arch):
    """The port's own init: the reference's tree and shapes, its
    distributions (threefry's bits cannot be reproduced)."""
    cfg = get_config(arch).reduced().with_(d_model=256, vocab=4096)
    p = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build(jax_get_config(arch).reduced().with_(
            d_model=256, vocab=4096)).init, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  to_numpy(p)) == jshapes
    layers = p["mamba_layers" if arch == "zamba2-2.7b" else "layers"]
    mix = layers["mixer"]
    d, di = cfg.d_model, 2 * cfg.d_model
    # truncated at ±2σ, the std is 0.8796σ
    for name, fan_in in (("w_z", d), ("w_x", d), ("w_out", di)):
        w = mix[name]
        assert abs(float(w.std()) / (0.8796 / fan_in ** 0.5) - 1) < 0.03
        assert float(w.abs().max()) <= 2.0 / fan_in ** 0.5 + 1e-6
    assert not torch.equal(mix["w_z"][0], mix["w_z"][1])   # layers differ
    H = cfg.ssm_heads
    assert torch.equal(mix["A_log"][1],
                       torch.log(torch.arange(1, H + 1, dtype=torch.float32)))
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert float(mix["D"].min()) == float(mix["D"].max()) == 1.0
    assert abs(float(p["embed"]["tok"].std()) / 0.02 - 1) < 0.02
    assert p["compute"]["embed"]["tok"].dtype == torch.bfloat16
    again = build(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["embed"]["tok"], p["embed"]["tok"])


def test_serving_cli_imports_no_jax_and_serves_the_hybrid():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy\n"
         "sys.argv = ['serve', '--arch', 'zamba2-2.7b', '--reduced', "
         "'--reference', '--device', 'cpu', '--steps', '4']\n"
         "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
         "bad = [m for m in sys.modules if m.split('.')[0] in "
         "('jax', 'jaxlib', 'repro', 'msgpack')]\n"
         "print('leaked', bad)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("continuation") == 4
    assert "leaked []" in out.stdout
