"""The port on a CUDA card: the hand-written kernels (CIFG cell, dp_clip,
flash attention, SSD scan) against their plain PyTorch versions, and the
serving paths through them. Every test here is
marked ``cuda`` and skips where there is no GPU. The file imports neither
JAX nor the JAX package, so it runs on a host that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: float32 results differ from the plain cell only in the order of
the sums, so atol 1e-5 / rtol 1e-4; with bfloat16 products a one-ulp
difference in a float32 sum can flip the bfloat16 rounding of h, so
atol 3e-2. Flash attention: float32 within 1e-5 (the sum order differs),
bfloat16 within 2e-2 (the tensor-core kernel rounds P to bf16 before PV and
its output once; the plain version rounds its float32 output once). SSD
scan: 1e-4 relative to the largest output (float32 sums in another order).
The sequence backward (`cell_bwd_seq`) is float32 throughout: atol 1e-5 /
rtol 1e-4 (the order of the product's sums and the last bit of exp and tanh
differ, over 16 reverse steps). The dp_clip accumulate is held bitwise: each
step is a rounded product and a rounded sum in slot order, however many
slots one launch folds; the chunked sum of squares is held bitwise to the
per-leaf kernel plus the plain clip factor, and to itself across chunks.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.cifg_cell import (LAUNCHES, cell_fwd, cell_seq_fwd,
                                           cifg_cell_ref, cifg_states)
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
    assert LAUNCHES["cifg_cell_fwd"] == before + 1     # one per sequence
    hr, cr = cifg_states(zx, h0, c0, w, cell="seq", compute_dtype="float32")
    _close(hs, hr, "float32", "hs")
    _close(cs, cr, "float32", "cs")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(1, 64), (3, 200), (10, 256), (256, 256),
                                 (20, 96)])
def test_sequence_kernel_matches_plain_on_card(cuda_device, B, H, dtype):
    zx, h0, c0, w = _inputs(B, H, cuda_device, seed=30, S=16)
    w = w.to(getattr(torch, dtype))
    before = LAUNCHES["cifg_cell_fwd"]
    hs, cs = cell_seq_fwd(zx, h0, c0, w)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_fwd"] == before + 1
    hr, cr = cifg_states(zx, h0, c0, w, cell="seq")
    _close(hs, hr, dtype, "hs")
    _close(cs, cr, dtype, "cs")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(3, 200), (17, 256)])
def test_sequence_kernel_prefix_and_one_step_chaining_are_bitwise(
        cuda_device, B, H, dtype):
    """hs[t] of a 9-step launch is the final state of a (t+1)-step launch
    and of t+1 chained one-step launches, bit for bit; a row does not depend
    on the batch."""
    zx, h0, c0, w = _inputs(B, H, cuda_device, seed=31, S=9)
    w = w.to(getattr(torch, dtype))
    hs, cs = cell_seq_fwd(zx, h0, c0, w)
    h, c = h0, c0
    for t in range(9):
        hp, cp = cell_seq_fwd(zx[:t + 1].contiguous(), h0, c0, w)
        assert torch.equal(hp[-1], hs[t]) and torch.equal(cp[-1], cs[t])
        h, c = cell_fwd(zx[t], h, c, w)
        assert torch.equal(h, hs[t]) and torch.equal(c, cs[t])
    r = B - 1
    h1, c1 = cell_seq_fwd(zx[:, r:r + 1].contiguous(), h0[r:r + 1].contiguous(),
                          c0[r:r + 1].contiguous(), w)
    assert torch.equal(h1[:, 0], hs[:, r]) and torch.equal(c1[:, 0], cs[:, r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S", [(1, 264, 16), (4, 264, 1), (256, 264, 16),
                                   (1, 520, 16), (4, 520, 16),
                                   (256, 520, 1)])
def test_sequence_kernel_takes_any_width(cuda_device, B, H, S, dtype):
    """H > 256: the wide route (w_h resident up to 512, streamed beyond)
    against the plain recurrence, one launch; prefix and S = 1 chaining
    bitwise, and a row does not depend on the batch."""
    zx, h0, c0, w = _inputs(B, H, cuda_device, seed=32, S=S)
    w = w.to(getattr(torch, dtype))
    before = LAUNCHES["cifg_cell_fwd"]
    hs, cs = cell_seq_fwd(zx, h0, c0, w)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_fwd"] == before + 1
    hr, cr = cifg_states(zx, h0, c0, w, cell="seq")
    _close(hs, hr, dtype, "hs")
    _close(cs, cr, dtype, "cs")
    h, c = h0, c0
    for t in range(S):
        h, c = cell_fwd(zx[t], h, c, w)
        assert torch.equal(h, hs[t]) and torch.equal(c, cs[t])
    hp, cp = cell_seq_fwd(zx[:max(1, S // 2)].contiguous(), h0, c0, w)
    assert torch.equal(hp, hs[:max(1, S // 2)])
    r = B - 1
    h1, c1 = cell_seq_fwd(zx[:, r:r + 1].contiguous(), h0[r:r + 1].contiguous(),
                          c0[r:r + 1].contiguous(), w)
    assert torch.equal(h1[:, 0], hs[:, r]) and torch.equal(c1[:, 0], cs[:, r])


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


def _seq_bwd_inputs(S, B, H, dev, seed):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((S, B, 3 * H)),
              rng.standard_normal((S, B, H)) * 0.3,
              rng.standard_normal((B, H)) * 0.3,
              rng.standard_normal((S, B, H)) * 0.1,
              rng.standard_normal((B, H)) * 0.1,
              rng.standard_normal((B, H)) * 0.1,
              rng.standard_normal((H, 3 * H)) / np.sqrt(H))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


@pytest.mark.parametrize("S", [1, 16])
@pytest.mark.parametrize("B,H", [(1, 64), (4, 64), (10, 256), (256, 256),
                                 (1, 264), (4, 264), (256, 264), (4, 520),
                                 (256, 520), (3, 200)])
def test_sequence_backward_kernel_matches_plain_on_card(cuda_device, S, B,
                                                         H):
    """cell_bwd_seq (one launch for the whole reverse recursion) against its
    plain loop, every route (H <= 256, the wide route resident and
    streamed); the same bits on a second run."""
    from repro_torch.kernels.cifg_cell import cell_bwd_seq, cell_bwd_seq_ref

    args = _seq_bwd_inputs(S, B, H, cuda_device, seed=S * H + B)
    before = LAUNCHES["cifg_cell_bwd_seq"]
    got = cell_bwd_seq(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_bwd_seq"] == before + 1
    for what, a, b in zip(("dz", "dh0", "dc0"), got, cell_bwd_seq_ref(*args)):
        assert a.shape == b.shape
        _close(a, b, "float32", what)
    assert all(torch.equal(a, b) for a, b in zip(got, cell_bwd_seq(*args)))


@pytest.mark.parametrize("H", [64, 256, 264])
def test_sequence_backward_rows_do_not_depend_on_batch(cuda_device, H):
    from repro_torch.kernels.cifg_cell import cell_bwd_seq

    z, cs, c0, dhs, dhf, dcf, w = _seq_bwd_inputs(5, 40, H, cuda_device,
                                                  seed=H)
    full = cell_bwd_seq(z, cs, c0, dhs, dhf, dcf, w)
    for r in (0, 17, 39):
        col = lambda t: t[:, r:r + 1].contiguous()  # noqa: E731
        row = lambda t: t[r:r + 1].contiguous()  # noqa: E731
        one = cell_bwd_seq(col(z), col(cs), row(c0), col(dhs), row(dhf),
                           row(dcf), w)
        assert torch.equal(one[0][:, 0], full[0][:, r])
        assert torch.equal(one[1][0], full[1][r])
        assert torch.equal(one[2][0], full[2][r])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [96, 256, 264])
def test_sequence_gradient_is_one_backward_launch_and_remat_bitwise(
        cuda_device, H, dtype):
    """cifg_sequence(cell="fused") on the card: the gradients come from one
    cell_bwd_seq launch, remat=True gives the same bits, and in float32 they
    agree with cell="seq" (the plain loop on the same card; in bfloat16 the
    two forwards may round h differently, which the gradients amplify)."""
    from repro_torch.kernels.cifg_cell import cifg_sequence

    zx, h0, c0, w = _inputs(6, H, cuda_device, seed=40, S=12)

    def grads(cell, remat):
        args = [t.clone().requires_grad_(True) for t in (zx, h0, c0, w)]
        hs, (hf, cf) = cifg_sequence(*args, cell=cell, compute_dtype=dtype,
                                     remat=remat)
        loss = (hs * hs).sum() + (hf * cf).sum()
        return torch.autograd.grad(loss, args)

    before = LAUNCHES["cifg_cell_bwd_seq"]
    g = grads("fused", False)
    assert LAUNCHES["cifg_cell_bwd_seq"] == before + 1
    g_remat = grads("fused", True)
    assert all(torch.equal(a, b) for a, b in zip(g, g_remat))
    if dtype == "float32":
        for a, b in zip(g, grads("seq", False)):
            _close(a, b, dtype)


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


def _clip_trees(C, dev, seed, offset=0):
    """C update trees of the shapes of a narrow LSTM's leaves (one ragged),
    from numpy; with ``offset`` 1 every leaf is a view one element into its
    storage (not 16-byte aligned)."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (301, 96), "b": (96, 768), "c": (7,), "d": (33, 5)}

    def leaf(shape):
        n = int(np.prod(shape))
        a = (rng.standard_normal(n + offset) * 0.01).astype(np.float32)
        return torch.from_numpy(a).to(dev)[offset:].view(shape)

    return [{k: leaf(v) for k, v in shapes.items()} for _ in range(C)]


@pytest.mark.parametrize("offset", [0, 1])
def test_sumsq_chunk_is_bitwise_the_per_leaf_kernel_and_clip_factor(
        cuda_device, offset):
    """One dp_sumsq launch for a chunk: each slot's ss, norm and factor are
    the bits of fused_sumsq (one launch per leaf) + clip_factor · mask; a
    masked slot's factor is 0; close to the plain float32 sums."""
    from repro_torch.core.clipping import clip_factor
    from repro_torch.kernels.dp_clip import (LAUNCHES as CLIP_LAUNCHES,
                                             fused_sumsq, sumsq_chunk)
    from repro_torch.kernels.dp_clip.ref import sumsq_ref

    trees = _clip_trees(16, cuda_device, 5, offset)
    trees[3] = {k: v * 1e3 for k, v in trees[3].items()}   # clipped
    mask = [torch.tensor(float(c != 5), device=cuda_device) for c in range(16)]
    before = CLIP_LAUNCHES["dp_sumsq"]
    ss, norms, factors = sumsq_chunk(trees, 0.8, mask)
    torch.cuda.synchronize()
    assert CLIP_LAUNCHES["dp_sumsq"] == before + 1
    for c, tree in enumerate(trees):
        s1 = fused_sumsq(tree)
        assert torch.equal(ss[c], s1)
        assert torch.equal(norms[c], torch.sqrt(s1))
        assert torch.equal(factors[c], clip_factor(torch.sqrt(s1), 0.8)
                           * mask[c])
        plain = sum(float(sumsq_ref(l)) for l in tree.values())
        assert abs(float(ss[c]) - plain) <= 1e-5 * plain
    assert float(factors[5]) == 0.0 and float(factors[3]) < 1.0


def test_sumsq_chunk_is_invariant_to_chunk_width_and_position(cuda_device):
    from repro_torch.kernels.dp_clip import sumsq_chunk

    trees = _clip_trees(16, cuda_device, 6)
    want = sumsq_chunk(trees, 0.5)
    for C in range(1, 17):
        for c0 in range(0, 16 - C + 1, max(1, C // 2)):
            got = sumsq_chunk(trees[c0:c0 + C], 0.5)
            for a, b in zip(got, want):
                assert torch.equal(a, b[c0:c0 + C])
    # a client in every slot of a chunk of others
    others = _clip_trees(8, cuda_device, 7)
    for pos in range(8):
        chunk = others[:pos] + [trees[0]] + others[pos + 1:]
        got = sumsq_chunk(chunk, 0.5)
        assert all(torch.equal(a[pos], b[0]) for a, b in zip(got, want))


@pytest.mark.parametrize("C", [1, 16])
def test_clip_accumulate_chunk_takes_trees_of_many_leaves(cuda_device, C):
    """A tree of more leaves than one dp_sumsq launch takes (MAX_LEAVES):
    the sums carried from launch to launch give each slot the norm of
    fused_sumsq, and the round sum is the slots folded with the factors of
    clip_factor · mask."""
    from repro_torch.core.clipping import clip_factor
    from repro_torch.kernels.dp_clip import (LAUNCHES as CLIP_LAUNCHES,
                                             clip_accumulate_chunk,
                                             clip_accumulate_chunk_leaf,
                                             fused_sumsq)
    from repro_torch.kernels.dp_clip.ops import MAX_LEAVES, MAX_PTRS

    rng = np.random.default_rng(11)

    def tree(scale):
        return {f"l{i:02d}": torch.from_numpy(
            (rng.standard_normal(37 * i + 3) * scale).astype(np.float32)).to(
                cuda_device) for i in range(MAX_LEAVES + 5)}

    trees = [tree(5.0 if c == 0 else 0.05) for c in range(C)]   # 0 clipped
    acc = tree(1.0)
    mask = [torch.tensor(float(C == 1 or c != C - 1), device=cuda_device)
            for c in range(C)]
    before = CLIP_LAUNCHES["dp_sumsq"]
    new_acc, norms = clip_accumulate_chunk(acc, trees, 0.8, mask)
    torch.cuda.synchronize()
    # two launches of leaves for each run of MAX_PTRS // MAX_LEAVES slots
    assert CLIP_LAUNCHES["dp_sumsq"] == before + 2 * -(-C // (MAX_PTRS
                                                             // MAX_LEAVES))
    factors = []
    for c, t in enumerate(trees):
        n1 = torch.sqrt(fused_sumsq(t))
        assert torch.equal(norms[c], n1)
        factors.append(clip_factor(n1, 0.8) * mask[c])
    assert float(factors[0]) < 1.0
    f = torch.stack(factors)
    for k, a in acc.items():
        want = clip_accumulate_chunk_leaf(a, [t[k] for t in trees], f)
        assert torch.equal(new_acc[k], want)


def _chunk_inputs(C, n, dev, seed, offset=0):
    """acc, C deltas and C factors (one of them 0); with ``offset`` 1 the
    tensors are views one element into their storage (not 16-byte
    aligned)."""
    rng = np.random.default_rng(seed)

    def t(scale=1.0):
        a = (rng.standard_normal(n + offset) * scale).astype(np.float32)
        return torch.from_numpy(a).to(dev)[offset:]

    f = rng.uniform(0.1, 1.0, C).astype(np.float32)
    f[C // 2] = 0.0
    return t(), [t(0.3) for _ in range(C)], torch.from_numpy(f).to(dev)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 127, 32769, 983040])
@pytest.mark.parametrize("C", [1, 2, 7, 16, 32])
def test_chunk_accumulate_kernel_is_bitwise_one_client_launches(
        cuda_device, C, n, offset):
    from repro_torch.kernels.dp_clip import LAUNCHES as CLIP_LAUNCHES
    from repro_torch.kernels.dp_clip import (clip_accumulate_chunk_leaf,
                                             clip_accumulate_leaf)
    from repro_torch.kernels.dp_clip.ref import clip_accumulate_chunk_ref

    acc, deltas, f = _chunk_inputs(C, n, cuda_device, C * n + offset, offset)
    assert (acc.data_ptr() % 16 == 0) == (offset == 0)
    before = CLIP_LAUNCHES["dp_clip_accumulate"]
    got = clip_accumulate_chunk_leaf(acc, deltas, f)
    assert CLIP_LAUNCHES["dp_clip_accumulate"] == before + 1
    seq = acc
    for c in range(C):
        seq = clip_accumulate_leaf(seq, deltas[c], f[c])
    torch.cuda.synchronize()
    assert torch.equal(got, seq)
    assert torch.equal(got, clip_accumulate_chunk_ref(acc, deltas, f))


@pytest.mark.parametrize("C", [1, 16, 32])
def test_chunk_accumulate_kernel_zero_factor_and_aliasing(cuda_device, C):
    from repro_torch.kernels.dp_clip import clip_accumulate_chunk_leaf
    from repro_torch.kernels.dp_clip.ref import clip_accumulate_chunk_ref

    n = 32771
    acc, deltas, f = _chunk_inputs(C, n, cuda_device, C)
    garbage = [torch.full_like(acc, 1e30 if c % 2 else -1e30)
               for c in range(C)]
    zeros = torch.zeros((C,), device=cuda_device)
    assert torch.equal(clip_accumulate_chunk_leaf(acc, garbage, zeros), acc)
    # a masked slot (factor 0) over garbage among live slots adds ±0
    mixed = list(deltas)
    mixed[C // 2] = garbage[0]
    assert torch.equal(clip_accumulate_chunk_leaf(acc, mixed, f),
                       clip_accumulate_chunk_leaf(acc, deltas, f))
    want = clip_accumulate_chunk_ref(acc, deltas, f)
    inplace = acc.clone()
    out = clip_accumulate_chunk_leaf(inplace, deltas, f, out=inplace)
    torch.cuda.synchronize()
    assert out is inplace and torch.equal(inplace, want)


def test_chunk_accumulate_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    from repro_torch.kernels.dp_clip import clip_accumulate_chunk_leaf

    acc, deltas, f = _chunk_inputs(4, 64, cuda_device, 3)
    with pytest.raises(ValueError, match="contiguous"):
        clip_accumulate_chunk_leaf(
            acc, [torch.stack([d, d], dim=1)[:, 0] for d in deltas], f)
    with pytest.raises(ValueError, match="is on"):
        clip_accumulate_chunk_leaf(acc, deltas, f.cpu())


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
    (1, 64, 300, 2, 2, 128), (1, 96, 200, 4, 2, 32),
    (2, 200, 70, 4, 4, 112),
    # the wide route: stablelm-12b's 160, 192, 256, and 170 (plain loads)
    (2, 200, 200, 4, 2, 160), (1, 130, 130, 2, 2, 192),
    (1, 160, 160, 2, 1, 256), (1, 100, 70, 2, 2, 170)])
def test_flash_kernel_matches_plain_on_card(cuda_device, B, Sq, Sk, H, KV,
                                            hd, causal, window, dtype):
    from repro_torch.kernels.flash_attention import (LAUNCHES as FA,
                                                     flash_attention,
                                                     flash_attention_ref)

    q, k, v = _flash_inputs(B, Sq, Sk, H, KV, hd, dtype, cuda_device, hd)
    before = dict(FA)
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    # bf16 runs on the tensor cores, f32 on the CUDA cores
    assert FA["flash_attention_fwd_tc"] == \
        before["flash_attention_fwd_tc"] + (dtype == "bfloat16")
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


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_tc_rows_do_not_depend_on_batch(cuda_device, causal, window):
    """The tensor-core kernel at zamba2's head dim: a row's bf16 output is
    the same bits whatever else is in the batch, and whether q, k and v
    take 16-byte copies or (views 2 bytes off alignment) plain loads."""
    from repro_torch.kernels.flash_attention import (LAUNCHES as FA,
                                                     flash_attention)

    qkv = _flash_inputs(4, 300, 300, 8, 8, 80, "bfloat16", cuda_device, 2)
    before = FA["flash_attention_fwd_tc"]
    full = flash_attention(*qkv, causal=causal, window=window)
    for b in (0, 3):
        one = flash_attention(*(t[b:b + 1] for t in qkv), causal=causal,
                              window=window)
        assert torch.equal(one[0], full[b])
    off = [torch.cat([torch.zeros_like(t[..., :1]), t], dim=-1)[..., 1:]
           for t in qkv]
    assert off[0].data_ptr() % 16 == 2
    assert torch.equal(flash_attention(*off, causal=causal, window=window),
                       full)
    assert FA["flash_attention_fwd_tc"] == before + 4


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
    (1, 200, 2, 64, 64), (2, 512, 8, 64, 64), (1, 256, 4, 64, 128),
    (1, 512, 32, 64, 128), (1, 256, 3, 128, 128), (1, 128, 5, 65, 33),
    # the wide route: p or N above 128
    (1, 256, 2, 64, 192), (1, 256, 2, 192, 64), (1, 256, 2, 256, 256),
    (2, 384, 3, 200, 130)])
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


@pytest.mark.parametrize("B,S,H,p,N", [(2, 512, 80, 64, 64),
                                       (1, 384, 32, 64, 128)])
def test_ssd_kernel_heads_do_not_depend_on_the_call(cuda_device, B, S, H, p,
                                                    N):
    """A subset of the heads (A sliced to match) gives those heads of the
    full call bit for bit, and bf16 x, B and C give exactly the result of
    their float32 casts."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    x, dt, Bm, Cm, A = _ssd_inputs(B, S, H, p, N, cuda_device, 6)
    y, st = ssd_scan(x, dt, Bm, Cm, A)
    for heads in ([0], [1, H // 2, H - 1], list(range(3, H, 7))):
        idx = torch.tensor(heads, device=cuda_device)
        ys, sts = ssd_scan(x[:, :, idx].contiguous(),
                           dt[:, :, idx].contiguous(), Bm, Cm,
                           A[idx].contiguous())
        assert torch.equal(ys, y[:, :, idx]) and torch.equal(sts, st[:, idx])
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    yb, sb = ssd_scan(xb, dt, Bb, Cb, A)
    yf, sf = ssd_scan(xb.float(), dt, Bb.float(), Cb.float(), A)
    assert torch.equal(yb, yf) and torch.equal(sb, sf)


# ------------------------------------- the engine and the Secret Sharer
#
# The engine on the card against the engine on the CPU, both fed one
# CPU-drawn stream of draws (`EngineDraws` over a CPU generator; float32
# products: atol 1e-5 / rtol 1e-4 on the params after 2 rounds, rtol 1e-4 on the losses and norms). Canary scores
# at the Random-Sampling chunk's shape (B 27,648, S 5) and beam search (B
# ≤ 5), card against CPU: relative to the largest score, float32 1e-5,
# bfloat16 1e-3 (a one-ulp flip of a bf16 rounding of h); ranks and beams
# equal but for near ties within that tolerance.

SCORE_TOL = {"float32": 1e-5, "bfloat16": 1e-3}


def _canary_data(vocab=300):
    from repro_torch.core.secret_sharer import make_canaries
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset

    ds = FederatedDataset(BigramCorpus(vocab_size=vocab, seed=0), n_users=40,
                          seq_len=6, sentences_per_user=8)
    canaries = make_canaries(torch.Generator().manual_seed(5), vocab,
                             grid=((1, 4), (2, 6)), per_config=1)
    ds.inject_canaries(canaries)
    return ds, canaries


@pytest.mark.parametrize("sampling", ["fixed", "poisson"])
def test_engine_round_on_card_matches_cpu(cuda_device, sampling):
    from repro_torch.configs import ClientConfig, DPConfig
    from repro_torch.core.secret_sharer import canary_eval_fn
    from repro_torch.fl.engine import EngineDraws, SimEngine
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.utils.pytree import tree_leaves

    model = build(get_config("gboard-cifg-lstm").with_(
        **SMALL, compute_dtype="float32"))
    ds, canaries = _canary_data()
    dp = DPConfig(clients_per_round=8, noise_multiplier=0.3, clip_norm=0.05,
                  server_opt="momentum", server_lr=0.5, server_momentum=0.9,
                  sampling=sampling)
    cl = ClientConfig(batch_size=4, lr=0.3)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        e = SimEngine(model, ds.to_device_arrays(), dp, cl,
                      n_local_batches=2, availability=1.0, rounds_per_call=2,
                      eval_fn=canary_eval_fn(model, canaries), eval_every=2,
                      device=dev)
        for c in (LAUNCHES, clip_ops.LAUNCHES):
            for k in c:
                c[k] = 0
        draws = EngineDraws(torch.Generator().manual_seed(0))
        out[dev.type] = e.run(e.init_state(params, draws=draws), 2)
        if dev.type == "cuda":
            # a chunk with a live slot computes as one batched program, one
            # launch of each cell kernel per local batch (the round's slots
            # are the first n_clients, so ceil(n / chunk) chunks)
            c = e.cohort_chunk
            chunks = sum(-(-int(n) // c) for n in out["cuda"][1]["n_clients"])
            assert LAUNCHES["cifg_cell_bwd_seq"] == 2 * chunks
            assert LAUNCHES["cifg_cell_fwd"] == 2 * chunks + 1  # + eval
            assert clip_ops.LAUNCHES["dp_sumsq"] == chunks
    (sd, hd), (sc, hc) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(hd["n_clients"], hc["n_clients"])
    np.testing.assert_array_equal(sd.participation.cpu().numpy(),
                                  sc.participation.numpy())
    for k in ("loss", "mean_update_norm", "frac_clipped"):
        np.testing.assert_allclose(hd[k], hc[k], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(hd["eval"]["canary_logppl"],
                               hc["eval"]["canary_logppl"], rtol=1e-5)
    for a, b in zip(tree_leaves(sd.params), tree_leaves(sc.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def _peaked(model, seed=3):
    """Parameters whose next-word distributions are peaked (a uniform one
    makes every score alike)."""
    p = model.init(torch.Generator().manual_seed(seed), device="cpu")
    p = {k: v for k, v in p.items() if k != "compute"}
    p["embed"] = {"tok": p["embed"]["tok"] * 50.0}
    p["w_proj"] = p["w_proj"] * 4.0
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_score_canaries_at_the_rs_chunk_shape_on_card(cuda_device, dtype):
    """27 canaries x 1024 continuations: one forward of B 27,648, S 5."""
    from repro_torch.core.secret_sharer import (canary_matrix,
                                                make_canaries,
                                                random_sampling_ranks,
                                                score_canaries)
    from repro_torch.utils.pytree import tree_map

    model = build(get_config("gboard-cifg-lstm").with_(
        vocab=300, compute_dtype=dtype))
    p_cpu = _peaked(model)
    p_dev = tree_map(lambda l: l.to(cuda_device), p_cpu)
    canaries = make_canaries(torch.Generator().manual_seed(0), 300)
    toks = torch.from_numpy(canary_matrix(canaries))
    pool = torch.randint(0, 300, (1024, 3),
                         generator=torch.Generator().manual_seed(1))
    seqs = torch.cat([toks[:, None, :2].expand(27, 1024, 2),
                      pool[None].expand(27, 1024, 3).to(toks.dtype)],
                     dim=-1).reshape(-1, 5)
    before = LAUNCHES["cifg_cell_fwd"]
    got = score_canaries(model, p_dev, seqs.to(cuda_device)).cpu()
    assert LAUNCHES["cifg_cell_fwd"] == before + 1
    want = score_canaries(model, p_cpu, seqs)
    scale = float(want.abs().max())
    tol = SCORE_TOL[dtype] * scale
    assert float((got - want).abs().max()) <= tol
    can = score_canaries(model, p_cpu, toks)
    ranks = random_sampling_ranks(model, p_dev, canaries,
                                  continuations=pool.to(cuda_device))
    assert LAUNCHES["cifg_cell_fwd"] == before + 3
    pool_scores = want.reshape(27, 1024)
    want_ranks = (pool_scores < can[:, None]).sum(1).numpy()
    near = ((pool_scores - can[:, None]).abs() <= tol).sum(1).numpy()
    assert np.all(np.abs(ranks - want_ranks) <= near)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_beam_search_on_card_matches_cpu(cuda_device, dtype):
    from repro_torch.core.secret_sharer import (beam_search, canary_extracted,
                                                make_canaries)
    from repro_torch.utils.pytree import tree_map

    model = build(get_config("gboard-cifg-lstm").with_(
        vocab=300, compute_dtype=dtype))
    p_cpu = _peaked(model)
    p_dev = tree_map(lambda l: l.to(cuda_device), p_cpu)
    for c in make_canaries(torch.Generator().manual_seed(2), 300)[:6]:
        before = LAUNCHES["cifg_cell_fwd"]
        got = beam_search(model, p_dev, c.prefix, 5)
        assert LAUNCHES["cifg_cell_fwd"] == before + 3   # B 1, 5, 5
        assert got == beam_search(model, p_cpu, c.prefix, 5)
        assert canary_extracted(model, p_dev, c) == \
            canary_extracted(model, p_cpu, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_kernels_repeat_bitwise_and_stay_in_bounds_at_memorize_shapes(
        cuda_device, dtype):
    """A race between threads or cluster peers would change a result from
    launch to launch; a stray write would touch the guard past the
    output."""
    from repro_torch.kernels import sanitize

    for _, B, S in sanitize.FWD_SHAPES:
        assert sanitize.check_fwd(S, B, 256, dtype, 5, cuda_device) == ""
    assert sanitize.check_bwd(16, 10, 256, 5, cuda_device) == ""


# ------------------------------------------- the fault model and resume
#
# A fault-on engine round on the card against the CPU on one CPU-drawn
# stream (the same tolerances as the fault-free engine test above; the
# round sizes, reported and accepted counts and verdicts exactly); a run
# state saved and restored on the card, bitwise; the checkpoint reader with
# no msgpack importable.

# the goal of 10 (of 12 selected) makes some rounds abort
FAULTS = dict(seed=3, dropout_prob=0.3, straggler_prob=0.2,
              straggler_mean_delay=2.0, round_deadline=3.0, corrupt_prob=0.2,
              report_goal=10)


def _fault_setup(cohort=8, server_opt="momentum"):
    from repro_torch.configs import ClientConfig, DPConfig
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset

    model = build(get_config("gboard-cifg-lstm").with_(
        **SMALL, compute_dtype="float32"))
    ds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), n_users=60,
                          seq_len=6, sentences_per_user=8)
    # Adam's step is about server_lr in every coordinate
    dp = DPConfig(clients_per_round=cohort, noise_multiplier=0.3,
                  clip_norm=0.05, server_opt=server_opt,
                  server_lr=0.5 if server_opt == "momentum" else 0.01,
                  server_momentum=0.9)
    return model, ds, dp, ClientConfig(batch_size=4, lr=0.3)


# Adam takes its bias correction from the step count that the commits
# select on the device
@pytest.mark.parametrize("server_opt", ["momentum", "adam"])
def test_fault_engine_rounds_on_card_match_cpu(cuda_device, server_opt):
    from repro_torch.fl.engine import EngineDraws, SimEngine
    from repro_torch.fl.faults import FaultConfig
    from repro_torch.kernels.dp_clip import ops as clip_ops
    from repro_torch.utils.pytree import tree_leaves

    model, ds, dp, cl = _fault_setup(server_opt=server_opt)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        e = SimEngine(model, ds.to_device_arrays(), dp, cl,
                      n_local_batches=2, availability=1.0, rounds_per_call=2,
                      fault_config=FaultConfig(**FAULTS), device=dev)
        for c in (LAUNCHES, clip_ops.LAUNCHES):
            for k in c:
                c[k] = 0
        draws = EngineDraws(torch.Generator().manual_seed(0))
        out[dev.type] = e.run(e.init_state(params, draws=draws), 4)
        if dev.type == "cuda":
            assert LAUNCHES["cifg_cell_bwd_seq"] > 0
            assert clip_ops.LAUNCHES["dp_sumsq"] > 0
    (sd, hd), (sc, hc) = out["cuda"], out["cpu"]
    for k in ("n_selected", "n_reported", "n_clients", "committed"):
        np.testing.assert_array_equal(hd[k], hc[k], err_msg=k)
    assert hd["committed"].any() and not hd["committed"].all()
    for k in ("loss", "mean_update_norm", "frac_clipped"):
        np.testing.assert_allclose(hd[k], hc[k], rtol=1e-4, atol=1e-6)
    for x, y in ((sd.params, sc.params),
                 (sd.opt_state.momentum, sc.opt_state.momentum),
                 (sd.opt_state.nu, sc.opt_state.nu)):
        for a, b in zip(tree_leaves(x), tree_leaves(y)):
            np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5,
                                       rtol=1e-4)
    assert int(sd.opt_state.count) == int(sc.opt_state.count)


@pytest.mark.parametrize("faults", [None, FAULTS],
                         ids=["faults-off", "faults-on"])
def test_run_state_on_card_resumes_bitwise(cuda_device, tmp_path,
                                           monkeypatch, faults):
    import sys

    from repro_torch.fl.faults import FaultConfig
    from repro_torch.fl.population import PopulationSim
    from repro_torch.fl.round import FederatedTrainer
    from repro_torch.train import checkpoint
    from repro_torch.utils.pytree import tree_leaves

    # the reader needs no msgpack (the card's host has none)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    model, ds, dp, cl = _fault_setup()

    def trainer():
        return FederatedTrainer(
            model, ds, dp, cl, pop=PopulationSim(len(ds.users),
                                                 availability=1.0),
            seed=0, n_local_batches=2, backend="engine", rounds_per_call=2,
            device=cuda_device,
            fault_config=None if faults is None else FaultConfig(**faults))

    full = trainer()
    full.train(4)
    part = trainer()
    part.train(2)
    path = tmp_path / "state.msgpack"
    part.save_run_state(path)
    tree, meta = checkpoint.load(path)
    assert meta["kind"] == "trainer-run-state" and meta["round_idx"] == "2"
    resumed = trainer()
    assert resumed.restore_run_state(path) == 2
    resumed.train(2)
    for a, b in zip(tree_leaves(resumed.state.params),
                    tree_leaves(full.state.params)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert resumed.state.history == full.state.history
    assert resumed.accountant.rounds == full.accountant.rounds


# ------------------------- the streamed population and the sharded sampler
#
# The streamed backend on the card against the device backend, bitwise (one
# generator on the card, the same draws launched in the same order); the
# staging, whose two pinned host buffers and two device buffers are each
# reused two rounds later, while a long kernel each round holds the compute
# stream back behind the non-blocking copies; the sharded sampler's cohorts
# on the card against the CPU's on one CPU stream of block draws.


def _fleet_setup(sampling="fixed"):
    from repro_torch.configs import ClientConfig, DPConfig
    from repro_torch.data.corpus import BigramCorpus
    from repro_torch.data.federated import FederatedDataset
    from repro_torch.data.population_store import InMemoryPopulationStore

    model = build(get_config("gboard-cifg-lstm").with_(
        **SMALL, compute_dtype="float32"))
    ds = FederatedDataset(BigramCorpus(vocab_size=300, seed=0), n_users=60,
                          seq_len=6, sentences_per_user=8)
    dp = DPConfig(clients_per_round=8, noise_multiplier=0.3, clip_norm=0.05,
                  server_opt="momentum", server_lr=0.5, server_momentum=0.9,
                  sampling=sampling)
    return (model, InMemoryPopulationStore.from_dataset(ds), dp,
            ClientConfig(batch_size=4, lr=0.3))


def _same_state(a, b):
    from repro_torch.utils.pytree import tree_leaves

    for x, y in ((a.params, b.params),
                 (a.opt_state.momentum, b.opt_state.momentum)):
        for u, v in zip(tree_leaves(x), tree_leaves(y)):
            assert u.device.type == "cuda" and torch.equal(u, v)
    assert torch.equal(a.participation, b.participation)
    assert torch.equal(a.last_round, b.last_round)


@pytest.mark.parametrize("sampler", ["global", "sharded"])
@pytest.mark.parametrize("sampling", ["fixed", "poisson"])
def test_streamed_is_bitwise_the_device_backend_on_card(cuda_device, sampler,
                                                        sampling):
    from repro_torch.fl.engine import SimEngine

    model, store, dp, cl = _fleet_setup(sampling)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    out = []
    for backend, meth in (("device", "run"), ("streamed", "run"),
                          ("streamed", "run_python")):
        e = SimEngine(model, store, dp, cl, n_local_batches=2,
                      availability=1.0, rounds_per_call=2, sampler=sampler,
                      population_backend=backend, device=cuda_device)
        out.append(getattr(e, meth)(e.init_state(params, seed=3), 4))
    for s, h in out[1:]:
        _same_state(s, out[0][0])
        for k in ("loss", "mean_update_norm", "n_clients"):
            np.testing.assert_array_equal(h[k], out[0][1][k])


def test_pinned_staging_reuses_each_buffer_after_two_rounds(cuda_device):
    """The compute stream sleeps ~20 ms a round in the eval hook, behind
    each round's non-blocking copy out of a pinned buffer: a staging write
    that did not wait for the copy and the compute two rounds back would
    overwrite a cohort still being read, and the trajectory would leave
    the device backend's."""
    from repro_torch.fl.engine import SimEngine

    model, store, dp, cl = _fleet_setup()
    params = model.init(torch.Generator().manual_seed(1), device="cpu")

    def slow_hook(p, r):
        torch.cuda._sleep(40_000_000)
        return {"w": p["w_h"].sum()}

    out = []
    for backend in ("device", "streamed"):
        e = SimEngine(model, store, dp, cl, n_local_batches=2,
                      availability=1.0, rounds_per_call=6, sampler="sharded",
                      population_backend=backend, eval_fn=slow_hook,
                      device=cuda_device)
        out.append(e.run(e.init_state(params, seed=3), 6))
    _same_state(out[1][0], out[0][0])
    np.testing.assert_array_equal(out[1][1]["eval"]["w"],
                                  out[0][1]["eval"]["w"])
    st = e._staging
    assert all(b.is_pinned() for b in st["host"]) and st["ids"].is_pinned()
    assert len(st["device"]) == 2 and e.corpus_device_bytes == \
        2 * e.padded * store.emax * store.row_len * 4


def test_sharded_cohorts_on_card_equal_the_cpus(cuda_device):
    from repro_torch.data.population_store import ReplicatedPopulationStore
    from repro_torch.fl.engine import EngineDraws, SimEngine

    model, store, dp, cl = _fleet_setup()
    fleet = ReplicatedPopulationStore(store, 200_000)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    states, engines = {}, {}
    for dev in (cuda_device, torch.device("cpu")):
        e = SimEngine(model, fleet, dp, cl, n_local_batches=2,
                      availability=0.3, sampler="sharded",
                      population_backend="streamed", device=dev)
        engines[dev.type] = e
        states[dev.type] = e.init_state(
            params, draws=EngineDraws(torch.Generator().manual_seed(0)))
    for r in range(5):
        ids = {}
        for k, e in engines.items():
            s = states[k]
            lr, part, cohort = e._sample_phase(s.draws, s.last_round,
                                               s.participation, r)
            states[k] = s._replace(last_round=lr, participation=part)
            ids[k] = cohort.ids.cpu()
        assert torch.equal(ids["cuda"], ids["cpu"])
    assert torch.equal(states["cuda"].last_round.cpu(),
                       states["cpu"].last_round)


# ------------------------------------------------ dense and MoE decoders


@pytest.mark.parametrize("arch,dtype", [("granite-3-2b", "float32"),
                                        ("granite-3-2b", "bfloat16"),
                                        ("phi3-mini-3.8b", "bfloat16"),
                                        ("olmoe-1b-7b", "float32")])
def test_decoder_serving_on_card_matches_cpu(cuda_device, arch, dtype):
    """A reduced decoder on the card against the same weights on the CPU:
    the prefill runs flash attention once per layer (the tensor-core form
    in bf16), the decode steps none. Logits within 1e-4 of the largest in
    float32 (sums in another order), 2e-2 in bfloat16 (the two round at
    different places). The MoE runs in float32 only: in bf16 the router
    reads activations that the two devices round differently, and a near
    tie among its 4 experts then sends a token elsewhere."""
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.utils.params import strip_compute, with_compute_copies
    from repro_torch.utils.pytree import tree_map

    cfg = get_config(arch).reduced().with_(compute_dtype=dtype)
    model = build(cfg)
    cpu_p = model.init(torch.Generator().manual_seed(0), device="cpu")
    card_p = with_compute_copies(
        tree_map(lambda t: t.to(cuda_device), strip_compute(cpu_p)), dtype,
        model.compute_copies)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        4, cfg.vocab, (2, 48)))
    nxt = torch.from_numpy(np.random.default_rng(3).integers(
        4, cfg.vocab, (3, 2)))
    tol = 1e-4 if dtype == "float32" else 2e-2
    outs = {}
    for name, p in (("cuda", card_p), ("cpu", cpu_p)):
        dev = cuda_device if name == "cuda" else torch.device("cpu")
        before = dict(FA)
        last, cache = model.prefill(p, {"tokens": toks.to(dev)}, max_len=56)
        after = dict(FA)
        steps = [last]
        for t in range(3):
            lg, cache = model.decode_step(p, nxt[t].to(dev), cache)
            steps.append(lg)
        if name == "cuda":
            torch.cuda.synchronize()
            assert after["flash_attention_fwd"] == \
                before["flash_attention_fwd"] + cfg.n_layers
            assert after["flash_attention_fwd_tc"] == \
                before["flash_attention_fwd_tc"] + cfg.n_layers * (
                    dtype == "bfloat16")
        assert FA == after                       # no launch in decode
        outs[name] = [s.float().cpu() for s in steps]
    scale = float(outs["cpu"][0].abs().max())
    for t, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
        err = float((a - b).abs().max())
        assert err <= tol * scale, (t, err, scale)


# ------------------------------------ training through the kernels (C1)


def _grads_of(out, inputs, cot):
    outs = out if isinstance(out, tuple) else (out,)
    pairs = [(o, c) for o, c in zip(outs, cot) if c is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [c for _, c in pairs], allow_unused=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd,causal,window", [
    (2, 128, 128, 4, 2, 64, True, 0), (2, 64, 300, 4, 4, 64, False, 0),
    (1, 200, 200, 4, 1, 80, True, 64), (1, 130, 130, 2, 2, 160, True, 0)])
def test_flash_is_differentiable_on_card(cuda_device, B, Sq, Sk, H, KV, hd,
                                         causal, window, dtype):
    """The kernel's output carries a grad_fn; its gradients are those of
    the plain version's autograd on the same inputs (the backward is that
    recomputation: within 1e-6 of the largest in float32, the same bf16
    values in bfloat16, where both run one rounding), and the backward
    launches no kernel."""
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)

    ins = [t.requires_grad_(True) for t in _flash_inputs(
        B, Sq, Sk, H, KV, hd, dtype, cuda_device, Sk)]
    cot = (torch.randn((B, Sq, H, hd), device=cuda_device).to(ins[0].dtype),)
    before = FA["flash_attention_fwd"]
    out = flash_attention(*ins, causal=causal, window=window)
    assert out.grad_fn is not None
    got = _grads_of(out, ins, cot)
    torch.cuda.synchronize()
    assert FA["flash_attention_fwd"] == before + 1
    want = _grads_of(flash_attention_ref(*ins, causal=causal, window=window),
                     ins, cot)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g).all()
        err = float((g.float() - w.float()).abs().max())
        assert err <= 1e-6 * float(w.float().abs().max()), err


@pytest.mark.parametrize("S,state_cot", [(256, True), (200, False),
                                         (64, True)])
def test_ssd_scan_is_differentiable_on_card(cuda_device, S, state_cot):
    """Both outputs carry a grad_fn; the gradients of x, dt, B, C and A are
    those of the plain chunked form's autograd (within 1e-6 of the largest:
    the same recomputation), the final state's cotangent also None; one
    counted launch, none in the backward."""
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.kernels.ssd_scan import ssd_scan

    ins = [t.requires_grad_(True) for t in _ssd_inputs(
        2, S, 4, 64, 32, cuda_device, S)]
    gen = torch.Generator(device=cuda_device).manual_seed(S)
    cot = (torch.randn((2, S, 4, 64), device=cuda_device, generator=gen),
           torch.randn((2, 4, 64, 32), device=cuda_device, generator=gen)
           if state_cot else None)
    before = SSD["ssd_scan"]
    y, state = ssd_scan(*ins)
    assert y.grad_fn is not None and state.grad_fn is not None
    got = _grads_of((y, state), ins, cot)
    torch.cuda.synchronize()
    assert SSD["ssd_scan"] == before + 1
    cpu = [t.detach().cpu().requires_grad_(True) for t in ins]
    want = _grads_of(ssd_scan(*cpu), cpu,
                     tuple(None if c is None else c.cpu() for c in cot))
    for g, w in zip(got, want):
        g = g.cpu()
        err = float((g - w).abs().max())
        assert torch.isfinite(g).all()
        assert err <= 1e-4 * float(w.abs().max()), err


FAMILY_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
                "whisper-small", "chameleon-34b")


def _family_batches(cfg, nb, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(4, cfg.vocab, (nb, B, S + 1))
    b = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal(
            (nb, B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = rng.standard_normal(
            (nb, B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_family_trains_on_card(cuda_device, arch):
    """A reduced model of each family in float32: every leaf gets a finite
    gradient through the kernels (two flash launches per attention and two
    SSD launches per mixer a step under remat: the forward and the
    recomputation), and one `user_update` on the card matches the CPU's on
    the same weights and batches (Δ within 1e-4 of ‖Δ‖, the norm and loss
    1e-5 relative, the clip flag equal)."""
    from repro_torch.configs import ClientConfig, DPConfig
    from repro_torch.fl.client import user_update
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.utils.params import strip_compute
    from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

    cfg = get_config(arch).reduced().with_(compute_dtype="float32")
    model = build(cfg)
    cpu_p = strip_compute(model.init(torch.Generator().manual_seed(0),
                                     device="cpu"))
    card_p = tree_map(lambda t: t.to(cuda_device), cpu_p)
    b = _family_batches(cfg, 2, 2, 16)
    one = {k: v[0].to(cuda_device) for k, v in b.items()}
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(card_p)]
    before = (FA["flash_attention_fwd"], SSD["ssd_scan"])
    grads = torch.autograd.grad(model.loss_fn(tree_unflatten(card_p, leaves),
                                              one), leaves)
    torch.cuda.synchronize()
    sites = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
             "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
             "hybrid": cfg.n_layers // cfg.hybrid_attn_every, "ssm": 0}
    mixers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    assert (FA["flash_attention_fwd"] - before[0],
            SSD["ssd_scan"] - before[1]) == (2 * sites[cfg.family],
                                              2 * mixers)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    client = ClientConfig(local_epochs=1, batch_size=2, lr=0.1)
    dp = DPConfig(clients_per_round=4, noise_multiplier=0.3, clip_norm=0.5)
    dc, nc, fc, lc = user_update(model, card_p,
                                 {k: v.to(cuda_device) for k, v in b.items()},
                                 client, dp)
    dh, nh, fh, lh = user_update(model, cpu_p, b, client, dp)
    a = torch.cat([t.cpu().ravel() for t in tree_leaves(dc)])
    h = torch.cat([t.ravel() for t in tree_leaves(dh)])
    assert bool(torch.isfinite(a).all())
    assert float((a - h).norm()) <= 1e-4 * float(h.norm())
    assert abs(float(nc) - float(nh)) <= 1e-5 * float(nh)
    assert abs(float(lc) - float(lh)) <= 1e-5 * float(lh)
    assert float(fc) == float(fh)


# ------------------------------------------------ the cohort over ranks


def test_sharded_rounds_on_card_are_bitwise_one_rank(cuda_device):
    """Two ranks on gloo sharing the card (NCCL refuses two ranks on one
    device), through the kernels: params, momentum, population vectors and
    history bitwise the one-rank engine's, and the launches of every
    kernel, summed over the ranks, the one rank's."""
    import torch_sharded_ranks as tr
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_ranks

    build.build()           # before any rank starts
    specs = [tr.run_spec("fixed", sigma=0.3, rounds=2),
             tr.run_spec("poisson faults", "poisson", faults=True,
                         rounds=2),
             tr.run_spec("sharded streamed", sampler="sharded",
                         backend="streamed", sigma=0.3, rounds=2)]
    one = tr.runs(cuda_device, specs, cell_path="fused")
    out = spawn_ranks(tr.runs, 2, (specs, 2, 1, "fused"), backend="gloo")
    for spec in specs:
        name = spec["name"]
        for res in out:
            assert not tr.same_run(res[name], one[name]), name
        assert one[name]["launches"]["cifg_cell_fwd"] > 0
        assert one[name]["launches"]["dp_sumsq"] > 0
        summed = {k: sum(res[name]["launches"][k] for res in out)
                  for k in one[name]["launches"]}
        assert summed == one[name]["launches"], name


# ------------------------------------------------ the production step


def test_production_step_on_card_matches_the_cpu(cuda_device):
    """The (1, 1) production train step (`launch.steps`) of a reduced
    granite-3-2b on the card, through the flash kernel, against the same
    step on the CPU: the params' update within 5e-2 of each leaf's largest
    (bfloat16 products rounded at other places), the clipped fraction
    equal, the loss within 1e-2 relative; and bitwise the computation with
    no mesh on the card."""
    import torch_step_ranks as sr
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import one_rank
    from repro_torch.utils.pytree import tree_map as tmap

    rng = np.random.default_rng(0)
    params = sr.init_params("granite-3-2b")
    toks = rng.integers(0, sr.config("granite-3-2b").vocab,
                        (sr.C, sr.S + sr.DECODE + 1)).astype(np.int32)
    case = sr.case("granite", "granite-3-2b", params, toks, z=0.0,
                   serve=False)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        before = flash_ops.LAUNCHES["flash_attention_fwd"]
        with one_rank(device=dev.type) as d:
            out[dev.type] = sr.run_cases(d, (1, 1), ("data", "model"),
                                         [case])["granite"]
        out[dev.type + "_launches"] = (
            flash_ops.LAUNCHES["flash_attention_fwd"] - before)
    # 2 layers x 2 (the forward and the remat recomputation) x 4 clients
    assert out["cuda_launches"] == 2 * 2 * sr.C
    assert out["cpu_launches"] == 0
    card, cpu = out["cuda"], out["cpu"]
    assert card["metrics"]["frac_clipped"] == cpu["metrics"]["frac_clipped"]
    np.testing.assert_allclose(card["metrics"]["loss"],
                               cpu["metrics"]["loss"], rtol=1e-2)
    for g, w, s in zip(tree_leaves_np(card["params"]),
                       tree_leaves_np(cpu["params"]),
                       tree_leaves_np(params)):
        assert np.abs((g - s) - (w - s)).max() <= \
            5e-2 * np.abs(w - s).max()
    # the mesh-free computation on the card, bitwise
    cfg = sr.config("granite-3-2b")
    model = build(cfg)
    from repro_torch.configs import DPConfig
    from repro_torch.core.server_optim import init_state
    p0 = tmap(lambda a: torch.from_numpy(np.array(a)).to(cuda_device),
              params)
    t = torch.from_numpy(toks).long().to(cuda_device)
    plain = ST.fed_train_step_plain(
        model, DPConfig(clients_per_round=sr.C, noise_multiplier=0.0,
                        clip_norm=0.8), p0, init_state(p0),
        {"tokens": t[:, :sr.S], "labels": t[:, 1:sr.S + 1]},
        torch.Generator(cuda_device).manual_seed(7))[0]
    for a, b in zip(tree_leaves_np(tmap(lambda x: x.cpu().numpy(), plain)),
                    tree_leaves_np(card["params"])):
        np.testing.assert_array_equal(a, b)


def tree_leaves_np(tree):
    from repro_torch.utils.pytree import tree_leaves
    return [np.asarray(l, np.float64) for l in tree_leaves(tree)]


# ------------------------------------------- the client axis (a chunk)


def _client_inputs(C, S, B, H, dev, seed, bwd=False):
    """Per-client inputs made client by client, so client c's are the same
    whatever C is: the forward's (zx, h0, c0, w_h) or the sequence
    backward's seven."""
    def one(c):
        rng = np.random.default_rng(seed * 1000 + c)
        if bwd:
            shapes = ((S, B, 3 * H, 1.0), (S, B, H, 0.3), (B, H, 0.3),
                      (S, B, H, 0.1), (B, H, 0.1), (B, H, 0.1),
                      (H, 3 * H, H ** -0.5))
        else:
            shapes = ((S, B, 3 * H, 1.0), (B, H, 0.3), (B, H, 0.3),
                      (H, 3 * H, H ** -0.5))
        return [rng.standard_normal(s[:-1]) * s[-1] for s in shapes]
    per = [one(c) for c in range(C)]
    return [torch.from_numpy(np.stack(a).astype(np.float32)).to(dev)
            for a in zip(*per)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [256, 264])
@pytest.mark.parametrize("C", [1, 16, 19])
def test_client_axis_forward_is_bitwise_one_client_launches(cuda_device, C,
                                                            H, dtype):
    """cell_seq_fwd with a client axis at the training shape (S 16, B 10),
    both routes: one launch for the chunk, each client bitwise its own
    one-client launch and within TOL of the plain version; with one w_h
    for every client (stride 0) bitwise the same launches on it."""
    zx, h0, c0, w = _client_inputs(C, 16, 10, H, cuda_device, seed=H)
    w = w.to(getattr(torch, dtype))
    before = LAUNCHES["cifg_cell_fwd"]
    hs, cs = cell_seq_fwd(zx, h0, c0, w)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_fwd"] == before + 1
    assert hs.shape == (C, 16, 10, H)
    for c in range(C):
        h1, c1 = cell_seq_fwd(zx[c], h0[c], c0[c], w[c])
        assert torch.equal(hs[c], h1) and torch.equal(cs[c], c1), c
    hr, cr = cifg_states(zx, h0, c0, w, cell="seq")
    _close(hs, hr, dtype, "hs")
    _close(cs, cr, dtype, "cs")
    hs0, cs0 = cell_seq_fwd(zx, h0, c0, w[0])
    for c in range(C):
        h1, c1 = cell_seq_fwd(zx[c], h0[c], c0[c], w[0])
        assert torch.equal(hs0[c], h1) and torch.equal(cs0[c], c1), c


@pytest.mark.parametrize("H", [256, 264, 520])
@pytest.mark.parametrize("C", [1, 16, 19])
def test_client_axis_backward_is_bitwise_one_client_launches(cuda_device, C,
                                                             H):
    """cell_bwd_seq with a client axis at the training shape, every route:
    one launch, each client bitwise its one-client launch, within the
    float32 tolerance of the plain loop."""
    from repro_torch.kernels.cifg_cell import cell_bwd_seq, cell_bwd_seq_ref

    args = _client_inputs(C, 16, 10, H, cuda_device, seed=H + 1, bwd=True)
    before = LAUNCHES["cifg_cell_bwd_seq"]
    got = cell_bwd_seq(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["cifg_cell_bwd_seq"] == before + 1
    for c in range(C):
        one = cell_bwd_seq(*[a[c] for a in args])
        assert all(torch.equal(a[c], b) for a, b in zip(got, one)), c
    for what, a, b in zip(("dz", "dh0", "dc0"), got,
                          cell_bwd_seq_ref(*args)):
        _close(a, b, "float32", what)


def _chunk_batches(C, nb, B, S, vocab, seed):
    """C clients' (n_batches, B, S) batches, client c's from its own seed."""
    out = []
    for c in range(C):
        rng = np.random.default_rng(seed * 1000 + c)
        ex = rng.integers(4, vocab, size=(nb, B, S + 1))
        mask = (rng.random((nb, B, S)) > 0.1).astype(np.float32)
        out.append((ex[..., :-1], ex[..., 1:], mask))
    return [np.stack(a) for a in zip(*out)]


def test_chunk_program_is_client_invariant_at_full_width(cuda_device):
    """The paper's CIFG-LSTM at full width (vocab 10,000, d 96, H 256,
    bf16): local_deltas of a chunk of C clients, C in {1, 2, 4, 8, 16, 19},
    gives every client the Δ and loss of its C = 1 program bit for bit, and
    launches each cell kernel once per local batch for the whole chunk."""
    from repro_torch.configs import ClientConfig
    from repro_torch.fl.client import local_delta, local_deltas
    from repro_torch.utils.pytree import tree_leaves, tree_map

    model = build(get_config("gboard-cifg-lstm"))
    params = model.init(torch.Generator().manual_seed(3), device=cuda_device)
    nb, B, S = 2, 10, 16
    toks, labels, mask = _chunk_batches(19, nb, B, S, 10_000, seed=5)
    allb = {"tokens": torch.from_numpy(toks).to(cuda_device),
            "labels": torch.from_numpy(labels).to(cuda_device),
            "mask": torch.from_numpy(mask).to(cuda_device)}
    cl = ClientConfig(local_epochs=1, batch_size=B, lr=0.3)
    ones = [local_delta(model, params, tree_map(lambda l: l[c], allb), cl)
            for c in range(19)]
    for C in (1, 2, 4, 8, 16, 19):
        f0, b0 = LAUNCHES["cifg_cell_fwd"], LAUNCHES["cifg_cell_bwd_seq"]
        deltas, losses = local_deltas(
            model, params, tree_map(lambda l: l[:C], allb), cl)
        torch.cuda.synchronize()
        assert LAUNCHES["cifg_cell_fwd"] - f0 == nb
        assert LAUNCHES["cifg_cell_bwd_seq"] - b0 == nb
        for c in range(C):
            d1, l1 = ones[c]
            assert torch.equal(losses[c], l1), (C, c)
            for a, b in zip(tree_leaves(deltas[c]), tree_leaves(d1)):
                assert torch.equal(a, b), (C, c)


def test_chunk_program_is_client_invariant_at_one_row(cuda_device):
    """The same at a client batch of one row (B 1), where the products'
    rows are fewest, and at chunk widths 3 and 17 that leave
    `numerics.CLIENT_TILE`'s last block part-filled: every client's Δ and
    loss are those of its C = 1 program bit for bit."""
    from repro_torch.configs import ClientConfig
    from repro_torch.fl.client import local_delta, local_deltas
    from repro_torch.utils.pytree import tree_leaves, tree_map

    model = build(get_config("gboard-cifg-lstm"))
    params = model.init(torch.Generator().manual_seed(4), device=cuda_device)
    nb, B, S = 2, 1, 16
    toks, labels, mask = _chunk_batches(17, nb, B, S, 10_000, seed=6)
    allb = {"tokens": torch.from_numpy(toks).to(cuda_device),
            "labels": torch.from_numpy(labels).to(cuda_device),
            "mask": torch.from_numpy(mask).to(cuda_device)}
    cl = ClientConfig(local_epochs=1, batch_size=B, lr=0.3)
    ones = [local_delta(model, params, tree_map(lambda l: l[c], allb), cl)
            for c in range(17)]
    for C in (3, 16, 17):
        deltas, losses = local_deltas(
            model, params, tree_map(lambda l: l[:C], allb), cl)
        for c in range(C):
            d1, l1 = ones[c]
            assert torch.equal(losses[c], l1), (C, c)
            for a, b in zip(tree_leaves(deltas[c]), tree_leaves(d1)):
                assert torch.equal(a, b), (C, c)


# ------------------------------------- every family's chunk of clients
#
# A chunk of clients trains as one program (`fl.client.local_deltas` →
# `Model.client_loss_fn`): each client's products with its own weights
# (`utils.numerics.client_matmul` / `client_einsum`, one call a client),
# attention and the SSD scan with the clients folded into their batch (one
# launch a chunk; their plain gradients a client at a time), the SSD scan
# with one A per batch row. Every check is bitwise.

# (name, rows M a client, K, N) of the zoo's products at full width, M as
# phase 13 of chip_smoke.py runs them (B 2 × S 64 or 128; whisper's encoder
# 2 × 1,500 frames); the one-hot embedding backward and the tied heads
ZOO_PRODUCTS = (
    ("granite q/o", 128, 2048, 2048), ("granite k/v", 128, 2048, 512),
    ("granite gate/up", 128, 2048, 8192), ("granite down", 128, 8192, 2048),
    ("granite head", 128, 2048, 49408),
    ("olmoe router", 128, 2048, 64), ("olmoe q", 128, 2048, 2048),
    ("mamba2 z/x", 256, 1024, 2048), ("mamba2 B/C", 256, 1024, 128),
    ("mamba2 dt", 256, 1024, 32), ("mamba2 out", 256, 2048, 1024),
    ("zamba2 z/x", 256, 2560, 5120), ("zamba2 out", 256, 5120, 2560),
    ("zamba2 up", 256, 2560, 10240), ("zamba2 down", 256, 10240, 2560),
    ("whisper encoder q", 3000, 768, 768), ("whisper up", 3000, 768, 3072),
    ("whisper down", 3000, 3072, 768), ("whisper decoder up", 128, 768, 3072),
    ("chameleon k/v", 128, 8192, 1024), ("chameleon up", 128, 8192, 22016),
    ("chameleon down", 128, 22016, 8192))


def _product_runs(fn, a, b, g):
    """fn's output and both gradients for every chunk width 1–8 (the first
    C clients) and for all 8 in reverse order."""
    runs = {}
    for C in list(range(1, 9)) + [-8]:
        idx = torch.arange(8) if C == -8 else torch.arange(C)
        if C == -8:
            idx = idx.flip(0)
        aa = a[idx].clone().requires_grad_(True)
        bb = b[idx].clone().requires_grad_(True)
        out = fn(aa, bb)
        ga, gb = torch.autograd.grad(out, (aa, bb), g[idx])
        runs[C] = [(out[j], ga[j], gb[j]) for j in range(len(idx))]
        del aa, bb, out, ga, gb
    return runs


def _assert_product_runs_invariant(runs, what):
    full = runs[8]
    for C in range(1, 8):
        for j in range(C):
            assert all(torch.equal(x, y) for x, y in zip(runs[C][j], full[j])
                       ), (what, C, j)
    for j in range(8):
        assert all(torch.equal(x, y) for x, y in zip(runs[-8][7 - j],
                                                     full[j])), (what, j)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name,M,K,N", ZOO_PRODUCTS)
def test_client_products_are_bitwise_across_chunk_widths(cuda_device, name,
                                                         M, K, N, dtype):
    """`client_matmul` at each product shape of the zoo's families: every
    client's output and both gradients the same bits at chunk widths 1–8
    and in reverse order, and a lone client's output that of the
    one-client `compute_mm`; the heads also in the transposed layout
    `embed.head_logits` hands on."""
    from repro_torch.utils.numerics import client_matmul, compute_mm

    g = torch.Generator(device=cuda_device).manual_seed(M + K + N)
    dt = getattr(torch, dtype)
    a = torch.randn((8, M, K), generator=g, device=cuda_device).to(dt)
    b = (torch.randn((8, K, N), generator=g, device=cuda_device)
         / K ** 0.5).to(dt)
    cot = torch.randn((8, M, N), generator=g, device=cuda_device).to(dt)
    _assert_product_runs_invariant(_product_runs(client_matmul, a, b, cot),
                                   name)
    assert torch.equal(client_matmul(a[:1], b[:1])[0], compute_mm(a[0], b[0]))
    if "head" in name:
        bt = b.transpose(1, 2).contiguous()
        _assert_product_runs_invariant(_product_runs(
            lambda x, w: client_matmul(x, w.transpose(1, 2)), a, bt, cot),
            name + " (transposed)")


@pytest.mark.parametrize("name,E,T,d,f", [
    ("olmoe experts up", 64, 32, 2048, 1024),
    ("olmoe experts down", 64, 32, 1024, 2048),
    ("granite-moe experts up", 40, 48, 1536, 512),
    ("granite-moe experts down", 40, 48, 512, 1536)])
def test_client_einsum_experts_are_bitwise_across_chunk_widths(
        cuda_device, name, E, T, d, f):
    """The MoE's per-client expert products (`client_einsum`,
    ``gecd,edf->gecf`` with every client's own experts) in bf16, at the
    capacity T of one 128-token group (phase 13's B 2 × S 64): each
    client's bits at widths 1–8."""
    from repro_torch.utils.numerics import client_einsum

    g = torch.Generator(device=cuda_device).manual_seed(E + T)
    a = torch.randn((8, 1, E, T, d), generator=g,
                    device=cuda_device).to(torch.bfloat16)
    b = (torch.randn((8, E, d, f), generator=g, device=cuda_device)
         / d ** 0.5).to(torch.bfloat16)
    cot = torch.randn((8, 1, E, T, f), generator=g,
                      device=cuda_device).to(torch.bfloat16)
    _assert_product_runs_invariant(_product_runs(
        lambda x, w: client_einsum("gecd,edf->gecf", x, w), a, b, cot), name)


@pytest.mark.parametrize("B,S,H,p,N", [(8, 128, 32, 64, 128),
                                       (8, 128, 80, 64, 64)])
def test_ssd_kernel_per_row_a_matches_plain_on_card(cuda_device, B, S, H, p,
                                                    N):
    """One A per batch row at mamba2-370m's and zamba2-2.7b's folded shapes
    (4 clients × B 2): within the SSD tolerance of the plain chunked form
    with the same (B, H) A, each row bitwise its own call with that row's
    (H,) A, in f32 and with bf16 inputs."""
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan

    x, dt, Bm, Cm, _ = _ssd_inputs(B, S, H, p, N, cuda_device, 11)
    rng = np.random.default_rng(12)
    A = -torch.from_numpy(np.exp(rng.standard_normal((B, H))).astype(
        np.float32)).to(cuda_device)
    before = SSD["ssd_scan"]
    y, st = ssd_scan(x, dt, Bm, Cm, A)
    torch.cuda.synchronize()
    assert SSD["ssd_scan"] == before + 1
    yr, sr = ssd_chunked(x, dt, Bm, Cm, A, torch.zeros_like(st))
    for got, want in ((y, yr), (st, sr)):
        err = float((got - want).abs().max() / want.abs().max())
        assert err < 1e-4, err
    for b in range(B):
        y1, s1 = ssd_scan(x[b:b + 1], dt[b:b + 1], Bm[b:b + 1], Cm[b:b + 1],
                          A[b])
        assert torch.equal(y1[0], y[b]) and torch.equal(s1[0], st[b])
    xb, Bb, Cb = (t.to(torch.bfloat16) for t in (x, Bm, Cm))
    yb, sb = ssd_scan(xb, dt, Bb, Cb, A)
    yf, sf = ssd_scan(xb.float(), dt, Bb.float(), Cb.float(), A)
    assert torch.equal(yb, yf) and torch.equal(sb, sf)


def test_ssd_kernel_stride_zero_a_is_the_shared_call(cuda_device):
    """A (B, H) A expanded from one row (stride 0, the kernel's a_stride 0)
    is bitwise the (H,) call, and a materialised copy of it (a_stride H)
    gives the same bits too."""
    from repro_torch.kernels.ssd_scan import ssd_scan

    x, dt, Bm, Cm, A = _ssd_inputs(4, 256, 32, 64, 128, cuda_device, 13)
    y, st = ssd_scan(x, dt, Bm, Cm, A)
    for rows in (A.expand(4, 32), A.expand(4, 32).contiguous()):
        y2, st2 = ssd_scan(x, dt, Bm, Cm, rows)
        assert torch.equal(y2, y) and torch.equal(st2, st)


@pytest.mark.parametrize("B", [1, 2, 10])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_chunk_is_bitwise_across_chunk_widths_on_card(cuda_device,
                                                             arch, dtype, B):
    """Each family reduced, at B 1, 2 and 10 (the training CLI's default
    client batch): `local_deltas` of chunks of 1–4 clients (and the four in
    reverse order) gives every client the same Δ and loss bit for bit, with
    one flash launch per attention site and one SSD launch per mixer a
    forward for the whole chunk (two under remat)."""
    from repro_torch.configs import ClientConfig
    from repro_torch.fl.client import local_deltas
    from repro_torch.kernels.flash_attention import LAUNCHES as FA
    from repro_torch.kernels.ssd_scan import LAUNCHES as SSD
    from repro_torch.utils.pytree import tree_leaves, tree_map

    cfg = get_config(arch).reduced().with_(compute_dtype=dtype)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=cuda_device)
    per = [_family_batches(cfg, 2, B, 32, seed=c) for c in range(4)]
    allb = {k: torch.stack([b[k] for b in per]).to(cuda_device)
            for k in per[0]}
    cl = ClientConfig(local_epochs=1, batch_size=B, lr=0.1)
    sites = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
             "encdec": cfg.n_enc_layers + 2 * cfg.n_layers,
             "hybrid": cfg.n_layers // cfg.hybrid_attn_every, "ssm": 0}
    mixers = cfg.n_layers if cfg.family in ("ssm", "hybrid") else 0
    runs = {}
    for order in ((0,), (0, 1), (0, 1, 2), (0, 1, 2, 3), (3, 2, 1, 0)):
        before = (FA["flash_attention_fwd"], SSD["ssd_scan"])
        deltas, losses = local_deltas(
            model, params, tree_map(lambda l: l[list(order)], allb), cl)
        torch.cuda.synchronize()
        assert (FA["flash_attention_fwd"] - before[0],
                SSD["ssd_scan"] - before[1]) == (4 * sites[cfg.family],
                                                  4 * mixers)
        runs[order] = {c: (tree_leaves(deltas[j]), losses[j])
                       for j, c in enumerate(order)}
    full = runs[(0, 1, 2, 3)]
    for order, got in runs.items():
        for c, (d, l) in got.items():
            assert torch.equal(l, full[c][1]), (arch, order, c)
            assert all(torch.equal(a, b) for a, b in zip(d, full[c][0])), (
                arch, order, c)
            assert all(bool(torch.isfinite(a).all()) for a in d)
