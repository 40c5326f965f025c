"""The port's MoE decoder (`repro_torch.models.moe`) against the JAX model:
the router (`route`) on the same inputs, then `moe_ffn`, ``forward`` (with
its aux loss), ``loss_fn``, the prefill and three decode steps at the
``reduced()`` widths of olmoe-1b-7b and granite-moe-3b-a800m (4 experts,
top-2) on the reference's ``init(PRNGKey(0))`` carried across by
`repro_torch.utils.params.from_jax_params`.

The router: the top-k experts and the dispatch pattern (which token-expert
pairs are kept, at which place in the expert) are held exactly, at the
reduced widths and at olmoe-1b-7b's full d 2048 × 64 experts, with and
without capacity drops, on inputs whose router products are exact. Where
the softmax is exact (every column of the router equal: all ties; or one
logit far above the rest: the others 0) the combine weights are held
bitwise, and the order among equal probabilities must be ``lax.top_k``'s
(the lower expert first). Elsewhere the combine is
held to 1e-6 absolute (weights ≤ 1): XLA's exp and torch's differ in the
last bit, so the float32 probabilities can differ by an ulp.

Tolerances of the model outputs, as a max abs error over the largest
reference logit: float32 1e-5, bfloat16 2e-2 (the reference's own test
tolerance); the aux loss to 1e-6 relative on the same router input (and
in a float32 model), 1e-3 in a bfloat16 model, whose router reads bf16
activations that the two frameworks round at different places; cache
leaves as ``tests/test_torch_transformer.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build as jax_build
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.models import moe as M
from repro_torch.utils.params import from_jax_params

ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
DTYPES = ("float32", "bfloat16")
S = 16
EXTRA = 8
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_CACHE = {"float32": 1e-5, "bfloat16": 5e-2}
TOL_AUX = {"float32": 1e-6, "bfloat16": 1e-3}
TOL_COMBINE = 1e-6


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype):
    jm = jax_build(jax_get_config(arch).reduced().with_(compute_dtype=dtype))
    jp = jm.init(jax.random.PRNGKey(0))
    pm = build(get_config(arch).reduced().with_(compute_dtype=dtype))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, from_jax_params(tree, pm.compute_copies, device="cpu",
                                       compute_dtype=dtype)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


def _close(got, want, tol, scale=None, what=""):
    got = np.asarray(got.float().numpy() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max())
    assert err <= tol * max(scale, 1e-30), (what, err, scale)


def _route_both(cfgs, x, w, capacity):
    jcfg, cfg = cfgs
    jc, ja = JM.route(jnp.asarray(x), {"router": {"w": jnp.asarray(w)}},
                      jcfg, capacity=capacity)
    tc, ta = M.route(torch.from_numpy(x), {"router": {"w": torch.from_numpy(
        w)}}, cfg, capacity=capacity)
    return np.asarray(jc), float(ja), tc.numpy(), float(ta)


def _cfgs(arch, full):
    if full:
        return jax_get_config(arch), get_config(arch)
    return jax_get_config(arch).reduced(), get_config(arch).reduced()


# (arch, full widths, capacity): the training capacity, a capacity that
# drops most pairs, and the group (no drop)
ROUTE_CASES = [("olmoe-1b-7b", False, None), ("olmoe-1b-7b", False, 8),
               ("granite-moe-3b-a800m", False, None),
               ("olmoe-1b-7b", True, None), ("olmoe-1b-7b", True, 8),
               ("olmoe-1b-7b", True, 512)]


@pytest.mark.parametrize("arch,full,capacity", ROUTE_CASES)
def test_route_matches_jax(arch, full, capacity):
    cfgs = _cfgs(arch, full)
    d, E = cfgs[1].d_model, cfgs[1].n_experts
    rng = np.random.default_rng(E + (capacity or 0))
    # dyadic inputs: every router product and sum is exact in float32, so
    # both sides rank the same logits (an inexact product can break a near
    # tie either way: phase 11 of chip_smoke.py counts those, card
    # against CPU)
    x = (rng.integers(-16, 17, (512, d)) / 16).astype(np.float32)
    w = (rng.integers(-64, 65, (d, E)) / 4096).astype(np.float32)
    jc, ja, tc, ta = _route_both(cfgs, x, w, capacity)
    assert tc.shape == jc.shape and tc.dtype == np.float32
    np.testing.assert_array_equal(tc > 0, jc > 0)     # kept pairs, places
    assert float(np.abs(tc - jc).max()) <= TOL_COMBINE
    assert abs(ta - ja) <= TOL_AUX["float32"] * abs(ja)
    if capacity == 8:
        assert (jc > 0).sum() < 512 * cfgs[1].top_k  # pairs were dropped


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("kind", ["all equal", "one winner"])
def test_route_ties_are_bitwise_and_in_lax_order(full, kind):
    """Exact softmax, so the combine is bitwise: every column equal (all E
    probabilities tie at 1/E, the first k experts win, in order), or one
    expert per token far ahead (probability 1, the others exactly 0: the
    k − 1 zero-weight picks are the lowest other experts, and they take
    places in their experts all the same)."""
    cfgs = _cfgs("olmoe-1b-7b", full)
    d, E = cfgs[1].d_model, cfgs[1].n_experts
    rng = np.random.default_rng(3)
    x = rng.standard_normal((96, d)).astype(np.float32)
    if kind == "all equal":
        w = np.repeat(rng.standard_normal((d, 1)), E, axis=1)
    else:
        x = np.abs(x)
        w = np.zeros((d, E))
        w[:, E // 2] = 1000.0
    w = w.astype(np.float32)
    for capacity in (None, 16):
        jc, ja, tc, ta = _route_both(cfgs, x, w, capacity)
        np.testing.assert_array_equal(tc, jc)
        assert ta == ja
    probs = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(w), -1)
    _, topi = M._top_k(probs, cfgs[1].top_k)
    _, want = jax.lax.top_k(jnp.asarray(probs.numpy()), cfgs[1].top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(want))


def test_top_k_orders_ties_as_lax():
    """Rows with many exact ties at several values, against lax.top_k."""
    rng = np.random.default_rng(5)
    probs = rng.choice(np.asarray([0.0, 0.125, 0.25, 0.5], np.float32),
                       (64, 16))
    for k in (1, 2, 8, 16):
        v, i = M._top_k(torch.from_numpy(probs), k)
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, dtype, dropless):
    """One layer's MoE on 2 × 300 tokens: two groups of 512, the second
    zero-padded, at the training capacity or the inference one."""
    jm, jp, pm, pp = _pair(arch, dtype)
    x = np.random.default_rng(1).standard_normal(
        (2, 300, jm.cfg.d_model)).astype(np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["moe"])
    tlp = jax.tree_util.tree_map(lambda a: a[0],
                                 pp["compute"]["layers"]["moe"])
    jy, jaux = JM.moe_ffn(jnp.asarray(x, dtype), jlp, jm.cfg,
                          dropless=dropless)
    ty, taux = M.moe_ffn(torch.from_numpy(x).to(getattr(torch, dtype)), tlp,
                         pm.cfg, dropless=dropless)
    assert ty.dtype == getattr(torch, dtype)
    _close(ty, jy, TOL[dtype], what="moe_ffn")
    assert abs(float(taux) - float(jaux)) <= \
        TOL_AUX["float32"] * abs(float(jaux))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_aux_and_loss_match_jax(arch, dtype):
    jm, jp, pm, pp = _pair(arch, dtype)
    toks = _tokens((2, S), jm.cfg.vocab, 2)
    labels = _tokens((2, S), jm.cfg.vocab, 3)
    mask = (np.random.default_rng(4).random((2, S)) < 0.8).astype(np.float32)
    for dropless in (False, True):
        jl, ja = jm.forward(jp, {"tokens": toks}, with_aux=True,
                            dropless=dropless)
        tl, ta = pm.forward(pp, {"tokens": torch.from_numpy(toks)},
                            with_aux=True, dropless=dropless)
        _close(tl, jl, TOL[dtype], what=f"logits dropless={dropless}")
        assert abs(float(ta) - float(ja)) <= \
            TOL_AUX[dtype] * abs(float(ja))
    batch = {"tokens": toks, "labels": labels, "mask": mask}
    jloss = float(jm.loss_fn(jp, batch))
    tloss = float(pm.loss_fn(pp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))
    assert abs(tloss - jloss) <= TOL[dtype] * abs(jloss)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    jm, jp, pm, pp = _pair(arch, dtype)
    toks = _tokens((2, S), jm.cfg.vocab, S)
    nxt = _tokens((3, 2), jm.cfg.vocab, S + 1)
    scale = float(np.abs(np.asarray(jm.forward(jp, {"tokens": toks}),
                                    np.float32)).max())
    jlast, jc = jm.prefill(jp, {"tokens": toks}, max_len=S + EXTRA)
    tlast, tc = pm.prefill(pp, {"tokens": torch.from_numpy(toks)},
                           max_len=S + EXTRA)
    _close(tlast, jlast, TOL[dtype], scale=scale, what="prefill")
    for k in ("k", "v", "pos"):
        _close(tc[k], jc[k], TOL_CACHE[dtype], what=k)
    for t in range(3):
        jl, jc = jm.decode_step(jp, jnp.asarray(nxt[t]), jc)
        tl, tc = pm.decode_step(pp, torch.from_numpy(nxt[t]), tc)
        _close(tl, jl, TOL[dtype], scale=scale, what=f"decode step {t}")
    for k in ("k", "v"):
        _close(tc[k], jc[k], TOL_CACHE[dtype], what=f"cache {k}")
    assert int(tc["pos"]) == S + 3


def test_router_keeps_float32_in_a_bfloat16_parameter_set():
    """The router reads its float32 weight; every other matrix, the experts
    included, has its bf16 copy."""
    _, _, _, pp = _pair("olmoe-1b-7b", "bfloat16")
    cm, pm_ = pp["compute"]["layers"]["moe"], pp["layers"]["moe"]
    assert cm["router"]["w"] is pm_["router"]["w"]
    assert cm["router"]["w"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        assert cm[name].dtype == torch.bfloat16
        assert torch.equal(cm[name], pm_[name].bfloat16())
    assert pp["compute"]["layers"]["attn"]["wq"].dtype == torch.bfloat16


def test_combine_weights_are_rounded_to_bfloat16_in_float32():
    """In a float32 run the combine weights are bf16 values all the same
    (the reference casts them whatever the compute dtype): the output is
    the experts' outputs weighted by the bf16-rounded combine."""
    _, _, pm, pp = _pair("olmoe-1b-7b", "float32")
    lp = jax.tree_util.tree_map(lambda a: a[0],
                                pp["compute"]["layers"]["moe"])
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 8, pm.cfg.d_model)).astype(np.float32))
    y, _ = M.moe_ffn(x, lp, pm.cfg, dropless=True)
    combine, _ = M.route(x.reshape(1, 8, -1), lp, pm.cfg, capacity=8)
    c16 = combine.bfloat16().float()
    assert not torch.equal(c16, combine)
    xe = torch.einsum("gtec,gtd->gecd", (c16 > 0).float(), x.reshape(1, 8, -1))
    h = torch.einsum("gecf,efd->gecd", torch.nn.functional.silu(
        torch.einsum("gecd,edf->gecf", xe, lp["w_gate"]))
        * torch.einsum("gecd,edf->gecf", xe, lp["w_up"]), lp["w_down"])
    want = torch.einsum("gtec,gecd->gtd", c16, h).reshape(1, 8, -1)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
