"""The port on a CUDA card: the hand-written kernels (CIFG cell, dp_clip,
flash attention, SSD scan) against their plain PyTorch versions, and the
serving paths through them. Every test here is
marked ``cuda`` and skips where there is no GPU. The file imports neither
JAX nor the JAX package, so it runs on a host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 results differ from the plain cell only in the order of
the sums, so atol 1e-5 / rtol 1e-4; with bfloat16 products a one-ulp
difference in a float32 sum can flip the bfloat16 rounding of h, so
atol 3e-2. Flash attention: float32 within 1e-5 (the sum order differs), bfloat16
within 2e-2 (the plain version's float32 output is rounded once). SSD scan:
1e-4 relative to the largest output (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.cifg_cell import (LAUNCHES, cell_fwd, cifg_cell_ref,
                                           cifg_states)
from repro_torch.models import build
from repro_torch.serve import NwpRequest, ServeEngine, reference_generate

pytestmark = pytest.mark.cuda

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}
SMALL = dict(vocab=300, d_model=32, d_ff=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, H, dev, seed=0, S=None):
    rng = np.random.default_rng(seed)
    zx_shape = (B, 3 * H) if S is None else (S, B, 3 * H)
    arrays = (rng.standard_normal(zx_shape),
              rng.standard_normal((B, H)) * 0.3,
              rng.standard_normal((B, H)) * 0.3,
              rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


def _close(a, b, dtype, what=""):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                               err_msg=what, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(1, 64), (3, 200), (256, 256)])
def test_kernel_matches_plain_on_card(cuda_device, B, H, dtype):
    zx, h, c, w = _inputs(B, H, cuda_device, seed=9)
    w = w.to(getattr(torch, dtype))
    before = LAUNCHES["cifg_cell_fwd"]
    hk, ck = cell_fwd(zx, h, c, w)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_fwd"] == before + 1
    hr, cr = cifg_cell_ref(zx, h, c, w)
    _close(hk, hr, dtype, "h")
    _close(ck, cr, dtype, "c")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_rows_do_not_depend_on_batch(cuda_device, dtype):
    zx, h, c, w = _inputs(300, 96, cuda_device, seed=10)
    w = w.to(getattr(torch, dtype))
    hb, cb = cell_fwd(zx, h, c, w)
    for r in (0, 17, 299):
        h1, c1 = cell_fwd(zx[r:r + 1].contiguous(), h[r:r + 1].contiguous(),
                          c[r:r + 1].contiguous(), w)
        assert torch.equal(h1[0], hb[r]) and torch.equal(c1[0], cb[r])


def test_kernel_states_match_plain_cell(cuda_device):
    zx, h0, c0, w = _inputs(5, 128, cuda_device, seed=11, S=7)
    before = LAUNCHES["cifg_cell_fwd"]
    hs, cs = cifg_states(zx, h0, c0, w, cell="fused", compute_dtype="float32")
    assert LAUNCHES["cifg_cell_fwd"] == before + 7
    hr, cr = cifg_states(zx, h0, c0, w, cell="seq", compute_dtype="float32")
    _close(hs, hr, "float32", "hs")
    _close(cs, cr, "float32", "cs")


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    zx, h, c, w = _inputs(4, 64, cuda_device, seed=12)
    with pytest.raises(ValueError, match="contiguous"):
        cell_fwd(zx, h.t().contiguous().t(), c, w)
    with pytest.raises(ValueError, match="is on"):
        cell_fwd(zx, h, c.cpu(), w)


def test_engine_through_the_kernel_matches_reference(cuda_device):
    model = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    params = model.init(torch.Generator().manual_seed(0), device=cuda_device)
    eng = ServeEngine(model, params, max_slots=4, top_k=3)
    assert eng.bucketed_admission
    rng = np.random.default_rng(13)
    reqs = [NwpRequest(prompt=tuple(int(t) for t in rng.integers(
        4, 300, int(rng.integers(2, 12)))), steps=5,
        temperature=0.8 if i % 2 else 0.0, seed=i if i % 2 else None)
        for i in range(7)]
    before = LAUNCHES["cifg_cell_fwd"]
    sids = [eng.submit(r) for r in reqs]
    eng.run()
    assert LAUNCHES["cifg_cell_fwd"] > before
    for req, sid in zip(reqs, sids):
        toks, cands = reference_generate(
            model, params, req.prompt, req.steps,
            temperature=req.temperature, seed=req.seed, top_k=3)
        assert eng.result(sid).tokens == toks
        np.testing.assert_array_equal(eng.result(sid).candidates, cands)


# ------------------------------------------------------- training kernels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(1, 64), (10, 200), (256, 256)])
def test_backward_kernel_matches_plain_on_card(cuda_device, B, H, dtype):
    from repro_torch.kernels.cifg_cell import cell_bwd, cell_bwd_ref

    zx, h, c, w = _inputs(B, H, cuda_device, seed=14)
    dh, dc = (t * 0.3 for t in _inputs(B, H, cuda_device, seed=15)[1:3])
    w = w.to(getattr(torch, dtype))
    before = LAUNCHES["cifg_cell_bwd"]
    got = cell_bwd(zx, w, h, c, dh, dc)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_bwd"] == before + 1
    for what, a, b in zip(("dzx", "dh", "dc", "dw_h"), got,
                          cell_bwd_ref(zx, w, h, c, dh, dc)):
        _close(a, b, dtype, what)
    assert all(torch.equal(a, b) for a, b in
               zip(got, cell_bwd(zx, w, h, c, dh, dc)))


def test_step_gradient_goes_through_the_backward_kernel(cuda_device):
    from repro_torch.kernels.cifg_cell import cifg_cell_ref, cifg_step

    zx, h, c, w = _inputs(6, 96, cuda_device, seed=16)
    args = [t.clone().requires_grad_(True) for t in (zx, h, c, w)]
    before = LAUNCHES["cifg_cell_bwd"]
    hn, cn = cifg_step(*args, compute_dtype="float32")
    gk = torch.autograd.grad((hn * hn).sum() + cn.sum(), args)
    assert LAUNCHES["cifg_cell_bwd"] == before + 1
    hr, cr = cifg_cell_ref(*args, compute_dtype="float32")
    gr = torch.autograd.grad((hr * hr).sum() + cr.sum(), args)
    for a, b in zip(gk, gr):
        _close(a, b, "float32")


@pytest.mark.parametrize("n", [1, 127, 32769, 983040])
def test_clip_kernels_match_plain_on_card(cuda_device, n):
    from repro_torch.kernels.dp_clip import LAUNCHES as CLIP_LAUNCHES
    from repro_torch.kernels.dp_clip import clip_accumulate_leaf, sumsq
    from repro_torch.kernels.dp_clip.ref import (clip_accumulate_ref,
                                                 sumsq_ref)

    rng = np.random.default_rng(n)
    x, acc = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .to(cuda_device) for _ in range(2))
    before = dict(CLIP_LAUNCHES)
    s = sumsq(x)
    torch.cuda.synchronize()
    assert torch.equal(s, sumsq(x))                  # fixed order, no atomics
    torch.testing.assert_close(s, sumsq_ref(x), rtol=1e-5, atol=0.0)
    f = torch.clamp(0.8 / torch.sqrt(s), max=1.0)
    assert torch.equal(clip_accumulate_leaf(acc, x, f),
                       clip_accumulate_ref(acc, x, f))
    garbage = torch.full_like(x, 1e30)
    assert torch.equal(clip_accumulate_leaf(acc, garbage,
                                            torch.zeros((), device=x.device)),
                       acc)
    assert CLIP_LAUNCHES["dp_sumsq"] == before["dp_sumsq"] + 2
    assert CLIP_LAUNCHES["dp_clip_accumulate"] == \
        before["dp_clip_accumulate"] + 2


def test_round_sum_is_bitwise_across_chunks_on_card(cuda_device):
    from repro_torch.configs import ClientConfig, DPConfig
    from repro_torch.fl.client import round_compute
    from repro_torch.utils.pytree import tree_leaves

    model = build(get_config("gboard-cifg-lstm").with_(**SMALL))
    params = model.init(torch.Generator().manual_seed(1), device=cuda_device)
    rng = np.random.default_rng(17)
    ex = rng.integers(4, 300, size=(16, 2, 4, 7))
    batches = {"tokens": ex[..., :-1], "labels": ex[..., 1:],
               "mask": np.ones(ex[..., 1:].shape, np.float32)}
    batches = {k: torch.from_numpy(np.asarray(v)).to(cuda_device)
               for k, v in batches.items()}
    mask = torch.ones(16)
    mask[[3, 10]] = 0.0
    cl, dp = ClientConfig(batch_size=4, lr=0.3), DPConfig(clip_norm=0.01)
    a = round_compute(model, params, batches, cl, dp, mask, cohort_chunk=1)
    b = round_compute(model, params, batches, cl, dp, mask, cohort_chunk=2)
    for x, y in zip(tree_leaves(a[0]), tree_leaves(b[0])):
        assert torch.equal(x, y)
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:]))


# --------------------------------------------- flash attention, SSD scan


def _flash_inputs(B, Sq, Sk, H, KV, hd, dtype, dev, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, getattr(torch, dtype))
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0), (False, 96)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (2, 256, 256, 4, 2, 64), (1, 100, 100, 2, 1, 32),
    (1, 200, 200, 4, 4, 80), (2, 130, 130, 4, 1, 96),
    (1, 64, 300, 2, 2, 128)])
def test_flash_kernel_matches_plain_on_card(cuda_device, B, Sq, Sk, H, KV,
                                            hd, causal, window, dtype):
    from repro_torch.kernels.flash_attention import (LAUNCHES as FA,
                                                     flash_attention,
                                                     flash_attention_ref)

    q, k, v = _flash_inputs(B, Sq, Sk, H, KV, hd, dtype, cuda_device, hd)
    before = FA["flash_attention_fwd"]
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA["flash_attention_fwd"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), atol=tol, rtol=tol)


def test_flash_kernel_reads_strided_views_and_rows_do_not_depend_on_batch(
        cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention

    qkv = _flash_inputs(3, 160, 160, 4, 2, 80, "bfloat16", cuda_device, 1)
    q, k, v = qkv
    full = flash_attention(q, k, v)
    for b in (0, 2):
        one = flash_attention(*(t[b:b + 1] for t in qkv))
        assert torch.equal(one[0], full[b])
    # views with a head stride of 2·hd, as a fused projection gives
    pq, pk, pv = (torch.stack([t, torch.zeros_like(t)], dim=3)[:, :, :, 0]
                  for t in qkv)
    assert pq.stride(2) == 2 * 80 and not pq.is_contiguous()
    assert torch.equal(flash_attention(pq, pk, pv), full)


def _ssd_inputs(B, S, H, p, N, dev, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, p))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
    Bm, Cm = rng.standard_normal((2, B, S, N))
    A = -np.exp(rng.standard_normal(H))
    return [torch.from_numpy(a.astype(np.float32)).to(dev)
            for a in (x, dt, Bm, Cm, A)]


@pytest.mark.parametrize("B,S,H,p,N", [
    (2, 256, 4, 64, 32), (1, 128, 2, 32, 16), (1, 384, 3, 16, 8),
    (1, 200, 2, 64, 64), (2, 512, 8, 64, 64), (1, 256, 4, 64, 128)])
def test_ssd_kernel_matches_plain_on_card(cuda_device, B, S, H, p, N):
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    x, dt, Bm, Cm, A = _ssd_inputs(B, S, H, p, N, cuda_device, S + N)
    before = SSD["ssd_scan"]
    y, st = ssd_scan(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert SSD["ssd_scan"] == before + 1
    pad = (-S) % 128
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
              for t in (x, dt, Bm, Cm)]
    yr, sr = ssd_chunked(*padded, A, torch.zeros_like(st))
    for got, want in ((y, yr[:, :S]), (st, sr)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-4, err


def test_ssd_kernel_rows_do_not_depend_on_batch(cuda_device):
    from repro_torch.kernels.ssd_scan import ssd_scan

    args = _ssd_inputs(3, 256, 4, 64, 64, cuda_device, 5)
    y, st = ssd_scan(*args)
    for b in (0, 2):
        y1, st1 = ssd_scan(*(t[b:b + 1] for t in args[:4]), args[4])
        assert torch.equal(y1[0], y[b]) and torch.equal(st1[0], st[b])
