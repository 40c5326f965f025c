"""The port on a CUDA card: the hand-written CIFG cell kernel against its
plain PyTorch version, and the serving path through it. Every test here is
marked ``cuda`` and skips where there is no GPU. The file imports neither
JAX nor the JAX package, so it runs on a host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 results differ from the plain cell only in the order of
the sums, so atol 1e-5 / rtol 1e-4; with bfloat16 products a one-ulp
difference in a float32 sum can flip the bfloat16 rounding of h, so
atol 3e-2.
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
