"""Every family of the zoo trains a cohort chunk as one batched program (the
reference's vmapped ``local_deltas``), on the CPU at the families'
``reduced()`` widths in float32: dense (granite-3-2b), MoE (olmoe-1b-7b),
SSM (mamba2-370m), hybrid (zamba2-2.7b), encoder-decoder (whisper-small)
and VLM (chameleon-34b), on parameters carried across from the reference's
``init(PRNGKey(0))`` and batches drawn from numpy seeds.

* the port's ``local_deltas`` at C 3 (2 local batches) against
  ``repro.fl.client.local_deltas`` (``jax.vmap`` of ``local_delta``):
  ‖Δ_port − Δ_ref‖ / ‖Δ_ref‖ ≤ 1e-5 per client and the losses within 1e-5
  relative, the tolerance of ``test_torch_family_training.py`` (float32
  sums in another order);
* within the port, bitwise: each client's Δ and loss across chunk widths 1,
  2 and 3 and with the clients in another order; ``client_loss_fn`` of
  stacked parameters against ``loss_fn`` of each client's own, the loss and
  every gradient leaf; ``round_compute`` across ``cohort_chunk`` 1, 2 and 4;
* the SSD scan's plain version with one ``A`` per batch row: bitwise its
  per-row calls with a shared ``A``, and its `RecomputeGrad` gradient with
  respect to a per-client ``A_log`` bitwise plain autograd.

The batches are B 3 × S 15, and the bitwise check across widths also runs
at B 1: a client's activations end part-way through a pair of the CPU's
vectors, where its silu, gelu, softplus and exp would take their scalar
code in one chunk and the vector code in another unless a client's call is
its own (`repro_torch.utils.numerics.client_apply`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ClientConfig as JClientConfig
from repro.configs import get_config as jax_get_config
from repro.fl.client import local_deltas as jax_local_deltas
from repro.models import build as jax_build
from repro_torch.configs import ClientConfig, DPConfig, get_config
from repro_torch.fl.client import local_deltas, round_compute
from repro_torch.kernels.recompute import RecomputeGrad
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import build
from repro_torch.utils.params import from_jax_params, strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten
# importing the autouse fixture `_one_thread` is what runs this file's tests
# on one torch thread (see its docstring); the import is not dead code
from test_torch_engine import _one_thread  # noqa: F401

FAMILIES = ("granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
            "whisper-small", "chameleon-34b")
NB, B, S = 2, 3, 15
TOL = 1e-5
CLIENT = dict(local_epochs=1, batch_size=B, lr=0.1)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jm = jax_build(jax_get_config(arch).reduced().with_(
        compute_dtype="float32"))
    pm = build(get_config(arch).reduced().with_(compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jm, jp, pm, strip_compute(from_jax_params(
        tree, pm.compute_copies, device="cpu", compute_dtype="float32"))


def _client_batches(cfg, c, B=B):
    """Client c's (NB, B, S) tokens and labels, and the family's stub
    inputs, from its own seed."""
    rng = np.random.default_rng(1000 + c)
    toks = rng.integers(4, cfg.vocab, (NB, B, S + 1)).astype(np.int32)
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (NB, B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (NB, B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def _chunk(cfg, clients, B=B):
    """The stacked (C, NB, B, S) batches of ``clients``, numpy."""
    per = [_client_batches(cfg, c, B) for c in clients]
    return {k: np.stack([b[k] for b in per]) for k in per[0]}


def _torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _port_chunk(arch, clients, B=B):
    """The port's ``local_deltas`` of ``clients`` as one chunk (batches of
    B rows) → (list of delta trees, losses (C,))."""
    _, _, pm, pp = _pair(arch)
    return local_deltas(pm, pp, _torch(_chunk(pm.cfg, clients, B)),
                        ClientConfig(**{**CLIENT, "batch_size": B}))


@pytest.mark.parametrize("arch", FAMILIES)
def test_local_deltas_match_the_reference_vmapped(arch):
    jm, jp, pm, _ = _pair(arch)
    batch = _chunk(jm.cfg, (0, 1, 2))
    jd, jl = jax.jit(lambda p, b: jax_local_deltas(
        jm, p, b, JClientConfig(**CLIENT)))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    deltas, losses = _port_chunk(arch, (0, 1, 2))
    want_leaves = [np.asarray(l, np.float32)
                   for l in jax.tree_util.tree_leaves(jd)]
    for c, delta in enumerate(deltas):
        want = np.concatenate([w[c].ravel() for w in want_leaves])
        got = np.concatenate([l.numpy().ravel() for l in tree_leaves(delta)])
        assert got.shape == want.shape
        assert np.linalg.norm(got - want) <= TOL * np.linalg.norm(want), (
            arch, c)
        assert abs(float(losses[c]) - float(jl[c])) <= TOL * abs(
            float(jl[c])), (arch, c)
    assert all(np.isfinite(l.numpy()).all() for d in deltas
               for l in tree_leaves(d))


@pytest.mark.parametrize("rows", [B, 1])
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_client_is_bitwise_across_chunk_widths(arch, rows):
    """Client 0 alone, in chunks of 2 and 3, and after the others; client 1
    first and second; client 2 last and first; at B 3 and B 1."""
    runs = {order: _port_chunk(arch, order, rows)
            for order in ((0,), (0, 1), (1, 0), (0, 1, 2), (2, 0, 1))}
    want = {}
    for order, (deltas, losses) in runs.items():
        for pos, c in enumerate(order):
            got = (tree_leaves(deltas[pos]), losses[pos])
            if c not in want:
                want[c] = got
                continue
            assert torch.equal(got[1], want[c][1]), (arch, order, c)
            assert all(torch.equal(x, y) for x, y in zip(got[0], want[c][0])
                       ), (arch, order, c)


@pytest.mark.parametrize("arch", FAMILIES)
def test_client_loss_fn_is_loss_fn_per_client(arch):
    """Three clients with parameters of their own (the carried set and two
    perturbed copies): each one's loss and gradient from the chunk are
    bitwise ``loss_fn``'s of its own parameters and first batch."""
    _, _, pm, pp = _pair(arch)
    sets = [pp] + [tree_map(lambda l, s=s: l + 0.01 * torch.from_numpy(
        np.random.default_rng(s).standard_normal(l.shape).astype(
            np.float32)), pp) for s in (1, 2)]
    batches = [{k: v[0] for k, v in _torch(_client_batches(pm.cfg, c)
                                           ).items()} for c in range(3)]
    stacked = tree_map(lambda *ls: torch.stack(ls), *sets)
    leaves = [l.detach().requires_grad_(True) for l in tree_leaves(stacked)]
    losses = pm.client_loss_fn(tree_unflatten(stacked, leaves),
                               tree_map(lambda *ls: torch.stack(ls),
                                        *batches))
    assert losses.shape == (3,)
    grads = torch.autograd.grad(losses.sum(), leaves)
    for c in range(3):
        one = [l.detach().requires_grad_(True) for l in tree_leaves(sets[c])]
        loss = pm.loss_fn(tree_unflatten(sets[c], one), batches[c])
        assert torch.equal(losses[c], loss), (arch, c)
        for g, w in zip(grads, torch.autograd.grad(loss, one)):
            assert torch.equal(g[c], w), (arch, c)


def test_round_sum_is_bitwise_across_cohort_chunks():
    """``round_compute`` of a reduced dense model over 32 clients, one of
    them masked out: canonical blocks of 4, each folded in chunks of 1, 2
    and 4 clients, the sum and the stats bitwise."""
    _, _, pm, pp = _pair("granite-3-2b")
    batch = _torch(_chunk(pm.cfg, tuple(range(32))))
    batch = tree_map(lambda l: l[:, :1], batch)
    client = ClientConfig(**CLIENT)
    dp = DPConfig(clients_per_round=32, noise_multiplier=0.3, clip_norm=0.5)
    mask = torch.ones((32,))
    mask[5] = 0.0
    outs = [round_compute(pm, pp, batch, client, dp, mask, cohort_chunk=k)
            for k in (1, 2, 4)]
    for total, *stats in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(
            tree_leaves(total), tree_leaves(outs[0][0])))
        assert all(torch.equal(x, y) for x, y in zip(stats, outs[0][1:]))


def _ssd_inputs(Bsz, S_, H, p, N, seed):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    dt = torch.nn.functional.softplus(t(Bsz, S_, H)) * 0.1
    A_log = t(Bsz, H) * 0.5
    return t(Bsz, S_, H, p), dt, t(Bsz, S_, N), t(Bsz, S_, N), A_log


@pytest.mark.parametrize("S_", [16, 200])
def test_ssd_plain_per_row_a_is_the_per_row_calls(S_):
    """(B, H) ``A`` against one call a row with that row's (H,) ``A``,
    bitwise, y and the final state; the wrapper takes both forms (and on
    the CPU a stride-0 (B, H) view is bitwise the shared (H,) call)."""
    x, dt, Bm, Cm, A_log = _ssd_inputs(4, S_, 3, 8, 4, seed=S_)
    A = -torch.exp(A_log)
    y, h = ssd_scan(x, dt, Bm, Cm, A)
    for b in range(4):
        yb, hb = ssd_scan(x[b:b + 1], dt[b:b + 1], Bm[b:b + 1], Cm[b:b + 1],
                          A[b])
        assert torch.equal(y[b], yb[0]) and torch.equal(h[b], hb[0])
    ys, hs = ssd_scan(x, dt, Bm, Cm, A[0])
    ye, he = ssd_scan(x, dt, Bm, Cm, A[0].expand(4, 3))
    assert torch.equal(ys, ye) and torch.equal(hs, he)
    with pytest.raises(ValueError, match="expected A"):
        ssd_scan(x, dt, Bm, Cm, A[:3])


def test_ssd_recompute_grad_per_client_a_log_is_plain_autograd():
    """Two clients of two rows each, ``A = −exp(A_log)`` per client expanded
    to its rows (as `mamba2.mixer_fwd` hands it on): `RecomputeGrad` with
    the plain forward in the kernel's place gives bitwise plain autograd's
    gradients, ``A_log``'s included (autograd sums each client's rows)."""
    x, dt, Bm, Cm, _ = _ssd_inputs(4, 128, 3, 8, 4, seed=7)
    A_log = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 3)).astype(np.float32))
    cot = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (4, 128, 3, 8)).astype(np.float32))

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (x, dt, Bm, Cm,
                                                        A_log)]
        rows = (-torch.exp(ins[4]))[:, None, :].expand(2, 2, 3).reshape(4, 3)
        y, h = fn(*ins[:4], rows)
        return torch.autograd.grad((y * cot).sum() + h.sum(), ins)

    want = grads(ssd_scan_plain)
    got = grads(lambda *a: RecomputeGrad.apply(ssd_scan_plain,
                                               ssd_scan_plain, *a))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool(want[4].abs().sum() > 0)
