"""Every family of the zoo trains in the port as in the reference: one
`repro_torch.fl.client.user_update` of each family at its ``reduced()``
widths in float32, on parameters carried across from the reference's
``init(PRNGKey(0))`` and batches drawn from a seed with numpy, against
``repro.fl.client.user_update``: the clipped Δ, the pre-clip norm,
``was_clipped`` and the loss. The dense (granite-3-2b), MoE (olmoe-1b-7b),
SSM (mamba2-370m), hybrid (zamba2-2.7b), encoder-decoder (whisper-small)
and VLM (chameleon-34b) families; the CPU's attention and SSD are the
kernels' plain versions.

Also: each family's loss gradients under remat (the default, per-layer
``torch.utils.checkpoint``) are bitwise those without it; the hybrid's
gradient, whose shared block sums the contributions of every site,
against ``jax.grad`` of the reference's loss; and the two kernels'
`RecomputeGrad`, run with its forward given as the plain version (the
kernels run on the card only), gives bitwise the gradients of plain
autograd, the SSD's final state included (its cotangent also ``None``).

Tolerances: Δ as ‖Δ_port − Δ_ref‖ / ‖Δ_ref‖ ≤ 1e-5 (float32 sums in
another order); the norm and the loss 1e-5 relative; ``was_clipped``
equal; the hybrid's gradient leaf by leaf within 1e-5 of the leaf's
largest entry (with 1e-7 of the largest gradient as the floor).
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.fl.client import user_update as jax_user_update
from repro.models import build as jax_build
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.fl.client import user_update
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.recompute import RecomputeGrad
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params, strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_unflatten
from test_torch_engine import _one_thread  # noqa: F401  (autouse: one thread)

FAMILIES = ("granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
            "whisper-small", "chameleon-34b")
NB, B, S = 2, 2, 16
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pair(arch, n_layers=None):
    kw = dict(compute_dtype="float32")
    if n_layers:
        kw["n_layers"] = n_layers
    jm = jax_build(jax_get_config(arch).reduced().with_(**kw))
    pm = build(get_config(arch).reduced().with_(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, strip_compute(from_jax_params(
        tree, pm.compute_copies, device="cpu", compute_dtype="float32"))


def _batches(cfg, seed=0):
    """(NB, B, S) tokens and labels, and the family's stub inputs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab, (NB, B, S + 1)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (NB, B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (NB, B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree):
    return np.concatenate([np.asarray(l, np.float32).ravel()
                           for l in jax.tree_util.tree_leaves(tree)])


@pytest.mark.parametrize("arch", FAMILIES)
def test_user_update_matches_jax(arch):
    jm, jp, pm, pp = _pair(arch)
    client = ClientConfig(local_epochs=1, batch_size=B, lr=0.1)
    dp = DPConfig(clients_per_round=4, noise_multiplier=0.3, clip_norm=0.5)
    b = _batches(jm.cfg)
    jd, jn, jc, jl = jax_user_update(jm, jp, b, client, dp)
    td, tn, tc, tl = user_update(pm, pp, _torch(b), client, dp)
    want = _flat(jd)
    got = np.concatenate([l.numpy().ravel() for l in tree_leaves(td)])
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want), arch
    assert abs(float(tn) - float(jn)) <= TOL * float(jn)
    assert abs(float(tl) - float(jl)) <= TOL * float(jl)
    assert float(tc) == float(jc)
    assert all(np.isfinite(l.numpy()).all() for l in tree_leaves(td))


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_are_bitwise_the_plain_ones(arch):
    _, _, pm, pp = _pair(arch)
    b = {k: v[0] for k, v in _torch(_batches(pm.cfg, seed=1)).items()}
    leaves = [l.detach().requires_grad_(True) for l in tree_leaves(pp)]
    q = tree_unflatten(pp, leaves)
    with_remat = torch.autograd.grad(pm.loss_fn(q, b), leaves)
    without = torch.autograd.grad(pm.loss_fn(q, b, remat=False), leaves)
    assert all(torch.equal(x, y) for x, y in zip(with_remat, without))
    # every leaf reaches the loss
    assert all(bool(g.abs().sum() > 0) for g in with_remat)


def test_hybrid_grads_match_jax_grad():
    """The shared block's gradient sums every site's contribution (two
    sites of two Mamba-2 layers each)."""
    jm, jp, pm, pp = _pair("zamba2-2.7b", n_layers=4)
    assert jm.cfg.n_layers // jm.cfg.hybrid_attn_every == 2
    b = {k: v[0] for k, v in _batches(jm.cfg, seed=2).items()}
    want = jax.grad(jm.loss_fn)(jp, b)
    leaves = [l.detach().requires_grad_(True) for l in tree_leaves(pp)]
    got = torch.autograd.grad(
        pm.loss_fn(tree_unflatten(pp, leaves),
                   {k: torch.from_numpy(v) for k, v in b.items()}), leaves)
    want_leaves = [np.asarray(l, np.float32)
                   for l in jax.tree_util.tree_leaves(want)]
    floor = 1e-7 * max(float(np.abs(w).max()) for w in want_leaves)
    for g, w in zip(got, want_leaves):
        assert g.shape == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL * float(np.abs(w).max()) + floor, err


def _grads(out, inputs, cot):
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, c) for o, c in zip(outs, cot) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [c for _, c in pairs], allow_unused=True)


@pytest.mark.parametrize("causal,window,Sk", [(True, 0, 20), (False, 0, 37),
                                              (True, 6, 20)])
def test_recompute_grad_is_plain_autograd_flash(causal, window, Sk):
    gen = torch.Generator().manual_seed(Sk)
    Sq = 20 if causal else 9
    q = torch.randn((2, Sq, 4, 16), generator=gen, requires_grad=True)
    k, v = (torch.randn((2, Sk, 2, 16), generator=gen, requires_grad=True)
            for _ in range(2))
    cot = (torch.randn((2, Sq, 4, 16), generator=gen),)

    def plain(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)

    out = RecomputeGrad.apply(plain, plain, q, k, v)
    assert out.grad_fn is not None
    got = _grads(out, (q, k, v), cot)
    want = _grads(plain(q, k, v), (q, k, v), cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("state_cot", [True, False])
def test_recompute_grad_is_plain_autograd_ssd(state_cot):
    gen = torch.Generator().manual_seed(3)
    Bz, Sp, H, p, N = 2, 128, 3, 8, 4
    x = torch.randn((Bz, Sp, H, p), generator=gen)
    dt = torch.rand((Bz, Sp, H), generator=gen) * 0.1
    Bm, Cm = (torch.randn((Bz, Sp, N), generator=gen) for _ in range(2))
    A = -torch.rand((H,), generator=gen) - 0.5
    ins = [t.requires_grad_(True) for t in (x, dt, Bm, Cm, A)]
    cot = (torch.randn((Bz, Sp, H, p), generator=gen),
           torch.randn((Bz, H, p, N), generator=gen) if state_cot else None)
    y, state = RecomputeGrad.apply(ssd_scan_plain, ssd_scan_plain, *ins)
    assert y.grad_fn is not None and state.grad_fn is not None
    got = _grads((y, state), ins, cot)
    want = _grads(ssd_scan_plain(*ins), ins, cot)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_multi_arch_example_runs_on_the_cpu_without_jax():
    """``python -m repro_torch.examples.multi_arch_training --device cpu``,
    in a subprocess on two intra-op threads: one row per assigned
    architecture, finite, and no module of JAX or the JAX package
    imported."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs import ASSIGNED_ARCHS

    root = Path(__file__).resolve().parents[1]
    code = ("import sys, torch; torch.set_num_threads(2); "
            "from repro_torch.examples import multi_arch_training as m; "
            "m.main(['--device', 'cpu']); "
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "print('leaked', bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    rows = {ln.split()[0]: ln.split()[1:] for ln in res.stdout.splitlines()
            if ln.split() and ln.split()[0] in ASSIGNED_ARCHS}
    assert list(rows) == list(ASSIGNED_ARCHS)
    for arch, (family, *nums) in rows.items():
        assert family == get_config(arch).family
        assert all(np.isfinite(float(x)) for x in nums)
    assert "leaked []" in res.stdout
