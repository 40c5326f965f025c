"""A cohort chunk trained as one batched program (the reference's vmapped
``local_deltas``) for the CIFG-LSTM, on the CPU at small widths (vocab 300,
d 16, H 32 and the wide route's H 264):

* the port's batched ``local_deltas`` at C = 4 against the reference's
  ``repro.fl.client.local_deltas`` (``jax.vmap`` of ``local_delta``) on the
  same parameters (carried with ``from_jax_params``) and batches;
* the plain versions of the cell kernels with a client axis (what the
  wrappers compute for CPU tensors) against their one-client calls, bitwise,
  at C 1–4, with per-client and shared ``w_h``;
* each client's Δ and loss bitwise equal across chunk widths 1, 2, 4, 8, and
  to the clients trained one after another through ``loss_fn``;
* the pieces: ``client_mm``, ``EmbedRows`` and ``lm_loss_clients`` with a
  client axis, the wrappers' shape checks, and that every family batches.

Tolerances against the reference: float32 atol 1e-5 / rtol 1e-4 and
bfloat16 atol 3e-2, each Δ leaf divided by the reference's largest entry of
the leaf (the frameworks order float32 sums differently, and a one-ulp
difference in a float32 sum can flip a bfloat16 rounding, as in
``test_torch_train.py``); the losses within the same tolerances. In float32
the Δ's absolute tolerance is at least 8 ulp of the leaf's largest
parameter: Δ = θ_local − θ0 is a difference of two float32 values of the
parameters' size, so a one-ulp difference in θ_local (the sum orders
again) moves it by ulp(θ), which is up to ~1% of a Δ of 1e-7. Within the
port the checks are bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import get_config as jax_get_config
from repro.fl.client import local_deltas as jax_local_deltas
from repro.models import build as jax_build
from repro_torch.configs import ALL_ARCHS, ClientConfig, get_config
from repro_torch.fl.client import local_delta, local_deltas, local_sgd
from repro_torch.kernels.cifg_cell import (cell_bwd, cell_bwd_seq,
                                           cell_bwd_seq_ref, cell_fwd,
                                           cell_seq_fwd, cifg_cell_ref,
                                           cifg_states)
from repro_torch.models import build
from repro_torch.models.embed import EmbedRows
from repro_torch.models.layers import lm_loss, lm_loss_clients
from repro_torch.utils.numerics import (client_apply, client_einsum,
                                        client_matmul, client_mm,
                                        compute_einsum, compute_mm,
                                        rowstable_mm)
from repro_torch.utils.params import from_jax_params, strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}
VOCAB = 300


def _cfg(H, dtype="bfloat16", cell="seq"):
    return dict(vocab=VOCAB, d_model=16, d_ff=H, compute_dtype=dtype,
                cell_path=cell)


def _chunk(C, nb=2, B=3, S=6, seed=1):
    """C clients' (n_batches, B, S) batches, client c's from its own seed,
    as numpy arrays."""
    per = []
    for c in range(C):
        rng = np.random.default_rng(seed * 100 + c)
        toks = rng.integers(4, VOCAB, (nb, B, S + 1)).astype(np.int32)
        per.append((toks[..., :-1], toks[..., 1:],
                    (rng.random((nb, B, S)) > 0.2).astype(np.float32)))
    return {k: np.stack(a) for k, a in zip(("tokens", "labels", "mask"),
                                          zip(*per))}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _model(H, dtype="bfloat16", cell="seq", seed=0):
    m = build(get_config("gboard-cifg-lstm").with_(**_cfg(H, dtype, cell)))
    return m, m.init(torch.Generator().manual_seed(seed), device="cpu")


def _same_tree(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


# ------------------------------------------------------ the reference


@pytest.mark.parametrize("H,dtype,cell", [(32, "float32", "seq"),
                                          (32, "bfloat16", "seq"),
                                          (32, "float32", "ref"),
                                          (264, "float32", "fused")])
def test_local_deltas_match_the_reference_vmapped(H, dtype, cell):
    """C = 4 clients, 2 local batches, 2 epochs: the port's one batched
    program against ``jax.vmap(local_delta)`` (the reference's cell path
    ``seq``, its Pallas cell's plain counterpart, stands in for ``fused``
    as in ``test_torch_train.py``)."""
    jm = jax_build(jax_get_config("gboard-cifg-lstm").with_(
        **_cfg(H, dtype, "seq" if cell == "fused" else cell)))
    jp = jm.init(jax.random.PRNGKey(3))
    pm = build(get_config("gboard-cifg-lstm").with_(**_cfg(H, dtype, cell)))
    pp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                         pm.compute_copies, device="cpu",
                         compute_dtype=dtype)
    batch = _chunk(4)
    kw = dict(local_epochs=2, batch_size=3, lr=0.3)
    jd, jl = jax.jit(lambda p, b: jax_local_deltas(
        jm, p, b, JClientConfig(**kw)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    deltas, losses = local_deltas(pm, pp, _torch(batch), ClientConfig(**kw))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), **TOL[dtype])
    for i, (want, p0) in enumerate(zip(jax.tree_util.tree_leaves(jd),
                                       jax.tree_util.tree_leaves(jp))):
        want = np.asarray(want, np.float32)
        got = np.stack([tree_leaves(d)[i].numpy() for d in deltas])
        scale = max(float(np.abs(want).max()), 1e-30)
        tol = dict(TOL[dtype])
        if dtype == "float32":
            ulp = float(np.spacing(np.abs(np.asarray(p0, np.float32)).max()))
            tol["atol"] = max(tol["atol"], 8 * ulp / scale)
        np.testing.assert_allclose(got / scale, want / scale, **tol)


# -------------------------------------- the plain versions, client axis


def _cell_args(C, S, B, H, seed, bwd=False):
    rng = np.random.default_rng(seed)
    if bwd:
        shapes = ((S, B, 3 * H, 1.0), (S, B, H, 0.3), (B, H, 0.3),
                  (S, B, H, 0.1), (B, H, 0.1), (B, H, 0.1),
                  (H, 3 * H, H ** -0.5))
    else:
        shapes = ((S, B, 3 * H, 1.0), (B, H, 0.3), (B, H, 0.3),
                  (H, 3 * H, H ** -0.5))
    return [torch.from_numpy((rng.standard_normal((C,) + s[:-1]) * s[-1])
                             .astype(np.float32)) for s in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [32, 264])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_plain_forward_client_axis_is_bitwise_one_client(C, H, dtype):
    zx, h0, c0, w = _cell_args(C, 5, 3, H, seed=C * 7 + H)
    w = w.to(dtype)
    hs, cs = cell_seq_fwd(zx, h0, c0, w)
    hsh, csh = cell_seq_fwd(zx, h0, c0, w[0])       # one w_h for every client
    hn, cn = cifg_cell_ref(zx[:, 0], h0, c0, w)
    hst, cst = cifg_states(zx, h0, c0, w, cell="seq")
    h1, c1 = cell_fwd(zx[:, 0].contiguous(), h0, c0, w)
    assert hs.shape == (C, 5, 3, H)
    for c in range(C):
        one = cell_seq_fwd(zx[c], h0[c], c0[c], w[c])
        assert torch.equal(hs[c], one[0]) and torch.equal(cs[c], one[1])
        assert torch.equal(hst[c], one[0]) and torch.equal(cst[c], one[1])
        shared = cell_seq_fwd(zx[c], h0[c], c0[c], w[0])
        assert torch.equal(hsh[c], shared[0]) and torch.equal(csh[c],
                                                              shared[1])
        step = cifg_cell_ref(zx[c, 0], h0[c], c0[c], w[c])
        assert torch.equal(hn[c], step[0]) and torch.equal(cn[c], step[1])
        assert torch.equal(h1[c], step[0]) and torch.equal(c1[c], step[1])


@pytest.mark.parametrize("H", [32, 264])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_plain_backward_client_axis_is_bitwise_one_client(C, H):
    args = _cell_args(C, 5, 3, H, seed=C * 11 + H, bwd=True)
    got = cell_bwd_seq(*args)
    ref = cell_bwd_seq_ref(*args)
    for c in range(C):
        one = cell_bwd_seq_ref(*[a[c] for a in args])
        assert all(torch.equal(a[c], b) for a, b in zip(got, one))
        assert all(torch.equal(a[c], b) for a, b in zip(ref, one))


def test_wrappers_check_the_client_axis():
    zx, h0, c0, w = _cell_args(3, 4, 2, 32, seed=1)
    with pytest.raises(ValueError):
        cell_seq_fwd(zx, h0[:2], c0, w)              # clients disagree
    with pytest.raises(ValueError):
        cell_seq_fwd(zx, h0, c0, w[:2])              # w_h of 2 clients
    with pytest.raises(ValueError):
        cell_seq_fwd(zx, h0, c0, w, hs=torch.empty(4, 2, 32))
    args = _cell_args(3, 4, 2, 32, seed=2, bwd=True)
    with pytest.raises(ValueError):
        cell_bwd_seq(*args[:6], args[6][:1])
    with pytest.raises(ValueError):
        cell_bwd_seq(args[0], args[1], args[2][:2], *args[3:])
    with pytest.raises(ValueError):                  # one step, no clients
        cell_bwd(zx[:, 0], w, h0, c0, h0, c0)


# ---------------------------------------------- the chunk's program


@pytest.mark.parametrize("H,cell", [(32, "seq"), (264, "seq"), (32, "ref")])
def test_client_deltas_are_bitwise_across_chunk_widths(H, cell):
    """Client c's Δ and loss are the same bits at chunk widths 1, 2, 4 and 8
    (width 1 is `local_delta`), and its local parameters those of
    `local_sgd`."""
    model, params = _model(H, cell=cell)
    batch = _torch(_chunk(8, nb=2, B=3, S=5, seed=4))
    cl = ClientConfig(local_epochs=2, batch_size=3, lr=0.3)
    d8, l8 = local_deltas(model, params, batch, cl)
    for C in (1, 2, 4):
        d, l = local_deltas(model, params, tree_map(lambda t: t[:C], batch),
                            cl)
        assert torch.equal(l, l8[:C])
        assert all(_same_tree(d[c], d8[c]) for c in range(C))
    for c in (0, 5):
        one = tree_map(lambda t: t[c], batch)
        d1, l1 = local_delta(model, params, one, cl)
        assert torch.equal(l1, l8[c]) and _same_tree(d1, d8[c])
        p1, lp = local_sgd(model, params, one, cl)
        assert torch.equal(lp, l8[c])
        assert _same_tree(tree_map(lambda a, b: a - b, p1, params), d8[c])


@pytest.mark.parametrize("H", [32, 264])
def test_batched_chunk_is_bitwise_the_clients_one_after_another(H):
    """On the CPU the batched program's products are one call a client and
    its elementwise steps position-independent, so each client's Δ is the
    bits of the one-client program through ``loss_fn`` (the losses average
    the local steps in another order: within 1e-6)."""
    model, params = _model(H)
    batch = _torch(_chunk(4, nb=2, B=3, S=5, seed=6))
    cl = ClientConfig(local_epochs=1, batch_size=3, lr=0.3)
    d, l = local_deltas(model, params, batch, cl)
    dl, ll = local_deltas(model._replace(client_loss_fn=None), params, batch,
                          cl)
    assert all(_same_tree(a, b) for a, b in zip(d, dl))
    np.testing.assert_allclose(l.numpy(), ll.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_client_losses_and_grads_are_loss_fns(dtype):
    """``client_loss_fn`` of stacked parameters: each client's loss and
    gradient bitwise ``loss_fn``'s on that client's own parameters."""
    model, _ = _model(32, dtype)
    per = [strip_compute(model.init(torch.Generator().manual_seed(s),
                                    device="cpu")) for s in range(3)]
    leaves = [torch.stack(ls).requires_grad_(True)
              for ls in zip(*[tree_leaves(p) for p in per])]
    stacked = tree_unflatten(per[0], leaves)
    batch = _torch({k: v[:, 0] for k, v in _chunk(3, seed=8).items()})
    losses = model.client_loss_fn(stacked, batch)
    grads = torch.autograd.grad(losses.sum(), leaves)
    for c in range(3):
        q = [l.detach()[c].clone().requires_grad_(True) for l in leaves]
        loss = model.loss_fn(tree_unflatten(stacked, q),
                             tree_map(lambda t: t[c], batch))
        assert torch.equal(loss, losses[c])
        g1 = torch.autograd.grad(loss, q)
        assert all(torch.equal(a[c], b) for a, b in zip(grads, g1))


# ------------------------------------------------------------ pieces


@pytest.mark.parametrize("rows", [True, False])
def test_client_mm_is_one_product_a_client_on_the_cpu(rows):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 24, 7)).astype(np.float32))
    got = client_mm(a, b, rows=rows)
    for c in range(3):
        want = rowstable_mm(a[c], b[c]) if rows else torch.mm(a[c], b[c])
        assert torch.equal(got[c], want)
    with pytest.raises(ValueError):
        client_mm(a, b[:2])
    with pytest.raises(ValueError):
        client_mm(a[0], b[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_client_products_are_each_clients_own_call(dtype):
    """`client_matmul` and `client_einsum`: client c's result is bitwise
    the one-client `compute_mm` / `compute_einsum` of its own operands, a
    transposed weight view included, and the shapes are checked."""
    g = torch.Generator().manual_seed(3)
    dt = getattr(torch, dtype)
    x = torch.randn((3, 2, 5, 7), generator=g).to(dt)
    w = torch.randn((3, 9, 7), generator=g)
    got = client_matmul(x, w.transpose(1, 2))
    for c in range(3):
        assert torch.equal(got[c], compute_mm(x[c], w[c].t()))
    e = torch.randn((3, 4, 7, 6), generator=g)
    got = client_einsum("gd,edf->egf", x[:, 0], e)
    for c in range(3):
        assert torch.equal(got[c], compute_einsum("gd,edf->egf", x[c, 0],
                                                  e[c]))
    with pytest.raises(ValueError, match="client_matmul"):
        client_matmul(x, w[:2].transpose(1, 2))


def test_client_apply_is_each_clients_own_call():
    """On the CPU an elementwise function of a chunk runs a client at a
    time: each client's values and gradient bitwise its own call's (a
    length whose tail leaves the vector code), in the input's layout."""
    g = torch.Generator().manual_seed(4)
    x = torch.randn((3, 5, 7), generator=g).transpose(1, 2)
    cot = torch.randn((3, 7, 5), generator=g)
    for fn in (torch.nn.functional.silu, torch.nn.functional.softplus,
               torch.exp):
        xs = x.clone().requires_grad_(True)
        out = client_apply(fn, xs, True)
        assert out.stride() == x.stride()
        (gx,) = torch.autograd.grad(out, xs, cot)
        for c in range(3):
            xc = x[c].clone().requires_grad_(True)
            yc = fn(xc)
            assert torch.equal(out[c], yc)
            assert torch.equal(gx[c], torch.autograd.grad(yc, xc, cot[c])[0])
    assert torch.equal(client_apply(torch.exp, x, False), torch.exp(x))


def test_embed_rows_with_a_client_axis():
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((3, 50, 8)).astype(
        np.float32)).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(0, 50, (3, 4, 5)))
    ids[:, 0, :2] = 7                               # repeated rows
    out = EmbedRows.apply(table, ids)
    grad = torch.from_numpy(rng.standard_normal(out.shape).astype(np.float32))
    (g,) = torch.autograd.grad(out, table, grad)
    for c in range(3):
        t1 = table.detach()[c].clone().requires_grad_(True)
        o1 = EmbedRows.apply(t1, ids[c])
        assert torch.equal(out[c], o1)
        assert torch.equal(g[c], torch.autograd.grad(o1, t1, grad[c])[0])


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_clients_is_lm_loss_per_client(masked):
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 2, 4, 512)).astype(
        np.float32) * 3)
    labels = torch.from_numpy(rng.integers(0, VOCAB, (3, 2, 4)))
    mask = torch.from_numpy((rng.random((3, 2, 4)) > 0.3).astype(np.float32))
    mask[1] = 0.0                                   # a client with no token
    got = lm_loss_clients(logits, labels, VOCAB, mask if masked else None)
    for c in range(3):
        want = lm_loss(logits[c], labels[c], VOCAB,
                       mask[c] if masked else None)
        assert torch.equal(got[c], want)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_family_batches_its_chunk(arch):
    """Every architecture's model trains a chunk as one program, built for
    its own configuration (``tests/test_torch_family_chunk.py`` holds each
    family's against the reference)."""
    cfg = get_config(arch)
    model = build(cfg)
    assert callable(model.client_loss_fn)
    assert model.client_loss_fn.keywords["cfg"] == cfg
