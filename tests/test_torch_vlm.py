"""The port's early-fusion VLM (`repro_torch.models.vlm`, chameleon-34b) at
its ``reduced()`` widths against the JAX model on the same parameters
(`from_jax_params`): forward logits with ``image_embeds`` replacing the
first ``n_image_tokens`` positions, the loss, and a prefill with image
embeddings followed by decode steps; the config and its tree.

Tolerances, as a max abs error over the largest reference logit: float32
1e-5 (the frameworks order float32 sums differently), bfloat16 2e-2 (the
two round at different places, as ``tests/test_torch_transformer.py``);
the loss 1e-5 relative in float32.
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
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params, to_numpy

ARCH = "chameleon-34b"
S = 16
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _pair(dtype):
    jm = jax_build(jax_get_config(ARCH).reduced().with_(compute_dtype=dtype))
    pm = build(get_config(ARCH).reduced().with_(compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab, (2, S + 1)).astype(np.int32)
    img = rng.standard_normal((2, cfg.n_image_tokens, cfg.d_model)
                              ).astype(np.float32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "image_embeds": img}


def _close(got, want, tol, scale=None, what=""):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_with_image_embeds_matches_jax(dtype):
    jm, jp, pm, pp = _pair(dtype)
    b = _batch(jm.cfg)
    want = np.asarray(jm.forward(jp, b), np.float32)
    got = pm.forward(pp, {k: torch.from_numpy(v) for k, v in b.items()})
    _close(got, want, TOL[dtype], what="logits")
    # the image embeddings decide the leading positions: other ones move
    # the logits there
    b2 = dict(b, image_embeds=b["image_embeds"] + 1.0)
    moved = pm.forward(pp, {k: torch.from_numpy(v) for k, v in b2.items()})
    assert not torch.equal(moved[:, 0], got[:, 0])


def test_loss_matches_jax():
    jm, jp, pm, pp = _pair("float32")
    b = _batch(jm.cfg, seed=3)
    want = float(jm.loss_fn(jp, b))
    got = float(pm.loss_fn(pp, {k: torch.from_numpy(v)
                                for k, v in b.items()}))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_prefill_with_image_then_decode_matches_jax():
    jm, jp, pm, pp = _pair("float32")
    b = _batch(jm.cfg, seed=4)
    b = {"tokens": b["tokens"], "image_embeds": b["image_embeds"]}
    jlast, jc = jm.prefill(jp, b, max_len=S + 2)
    tlast, tc = pm.prefill(pp, {k: torch.from_numpy(v) for k, v in b.items()},
                           max_len=S + 2)
    scale = float(np.abs(np.asarray(jlast)).max())
    _close(tlast, jlast, TOL["float32"], scale, what="last logits")
    for t, tok in enumerate(([5, 6], [7, 8])):
        jl, jc = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc)
        tl, tc = pm.decode_step(pp, torch.tensor(tok), tc)
        _close(tl, jl, TOL["float32"], scale, what=f"step {t}")


def test_config_and_tree_match_the_reference():
    cfg, ref = get_config(ARCH), jax_get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert dataclasses.asdict(cfg.reduced()) == \
        dataclasses.asdict(ref.reduced())
    p = build(cfg.reduced()).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(jax_build(ref.reduced()).init, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape),
                                  to_numpy(p)) == jshapes
    assert "head" in p["embed"]          # untied, as the reference
