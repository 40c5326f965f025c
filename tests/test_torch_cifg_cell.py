"""The port's CIFG cell (`repro_torch.kernels.cifg_cell`) against the JAX
package's: the plain cell against ``cifg_cell_ref``, the op against the
Pallas ``cifg_step`` run by its interpreter, ``cifg_states`` against the JAX
``cifg_states``; the wrapper's checks, its CPU rule and launch counter, the
row stability the serving engine relies on, and the kernel build.

Tolerances: float32 results differ only in the order of the sums, so
atol 1e-5 / rtol 1e-4; with bfloat16 products a one-ulp difference in a
float32 sum can flip the bfloat16 rounding of h at the next step, so
atol 3e-2. The kernel itself runs only on a CUDA card
(tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cifg_cell import cifg_cell_ref as jax_cell_ref
from repro.kernels.cifg_cell import cifg_states as jax_states
from repro.kernels.cifg_cell import cifg_step as jax_step
from repro_torch.kernels import build
from repro_torch.kernels.cifg_cell import (LAUNCHES, cell_fwd, cifg_cell_ref,
                                           cifg_states, cifg_step)
from repro_torch.utils.numerics import ROW_TILE, rowstable_mm

TOL = {"float32": dict(atol=1e-5, rtol=1e-4),
       "bfloat16": dict(atol=3e-2, rtol=0.0)}


def _inputs(B, H, seed=0, S=None):
    rng = np.random.default_rng(seed)
    zx_shape = (B, 3 * H) if S is None else (S, B, 3 * H)
    return (rng.standard_normal(zx_shape).astype(np.float32),
            (rng.standard_normal((B, H)) * 0.3).astype(np.float32),
            (rng.standard_normal((B, H)) * 0.3).astype(np.float32),
            (rng.standard_normal((H, 3 * H)) / np.sqrt(H)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(a, b, dtype, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), err_msg=what,
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(1, 8), (5, 48), (3, 200), (4, 256)])
def test_cell_ref_matches_jax_ref(B, H, dtype):
    zx, h, c, w = _inputs(B, H)
    hj, cj = jax_cell_ref(zx, h, c, w, compute_dtype=jnp.dtype(dtype))
    hp, cp = cifg_cell_ref(*_t(zx, h, c, w), compute_dtype=dtype)
    _close(hp, hj, dtype, "h")
    _close(cp, cj, dtype, "c")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H", [(5, 48), (4, 256)])
def test_cifg_step_matches_jax_pallas_interpret(B, H, dtype):
    """The port's op (plain cell on CPU tensors) against the Pallas kernel
    run by its interpreter, as tests/test_cifg_cell.py runs it."""
    zx, h, c, w = _inputs(B, H, seed=1)
    hj, cj = jax_step(zx, h, c, w, compute_dtype=dtype, interpret=True)
    hp, cp = cifg_step(*_t(zx, h, c, w), compute_dtype=dtype)
    _close(hp, hj, dtype, "h")
    _close(cp, cj, dtype, "c")


@pytest.mark.parametrize("cell", ["seq", "fused"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cifg_states_matches_jax(dtype, cell):
    zx, h0, c0, w = _inputs(3, 32, seed=2, S=6)
    hj, cj = jax_states(zx, h0, c0, w, cell="seq", compute_dtype=dtype)
    hp, cp = cifg_states(*_t(zx, h0, c0, w), cell=cell, compute_dtype=dtype)
    assert hp.shape == cp.shape == (6, 3, 32)
    _close(hp, hj, dtype, "hs")
    _close(cp, cj, dtype, "cs")


def test_cifg_states_is_causal_prefix_exact():
    """(hs[t], cs[t]) is bitwise the final state of the first t+1 steps —
    what the length-padded prefill gathers."""
    zx, h0, c0, w = _t(*_inputs(2, 16, seed=3, S=5))
    hs, cs = cifg_states(zx, h0, c0, w, cell="fused",
                         compute_dtype="bfloat16")
    for t in range(5):
        hp, cp = cifg_states(zx[:t + 1], h0, c0, w, cell="fused",
                             compute_dtype="bfloat16")
        assert torch.equal(hp[-1], hs[t]) and torch.equal(cp[-1], cs[t])


def test_cell_fwd_on_cpu_is_the_plain_cell_and_counts_no_launch():
    zx, h, c, w = _t(*_inputs(3, 24, seed=4))
    w = w.to(torch.bfloat16)
    before = LAUNCHES["cifg_cell_fwd"]
    hn, cn = cell_fwd(zx, h, c, w)
    hr, cr = cifg_cell_ref(zx, h, c, w)
    assert torch.equal(hn, hr) and torch.equal(cn, cr)
    h_out, c_out = torch.empty_like(h), torch.empty_like(c)
    ho, co = cell_fwd(zx, h, c, w, h_out=h_out, c_out=c_out)
    assert ho is h_out and co is c_out and torch.equal(h_out, hr)
    assert LAUNCHES["cifg_cell_fwd"] == before


@pytest.mark.parametrize("bad", ["zx_shape", "w_shape", "h_rank", "zx_dtype",
                                 "w_dtype", "out_shape"])
def test_cell_fwd_rejects_what_the_kernel_does_not_take(bad):
    zx, h, c, w = _t(*_inputs(2, 8, seed=5))
    kw = {}
    if bad == "zx_shape":
        zx = zx[:, :-1]
    elif bad == "w_shape":
        w = w[:, :-3]
    elif bad == "h_rank":
        h = h[0]
    elif bad == "zx_dtype":
        zx = zx.double()
    elif bad == "w_dtype":
        w = w.half()
    else:
        kw = {"h_out": torch.empty(3, 8), "c_out": torch.empty(2, 8)}
    with pytest.raises((ValueError, TypeError)):
        cell_fwd(zx, h, c, w, **kw)


def test_sequence_ops_validate_shapes_and_cell():
    zx, h0, c0, w = _t(*_inputs(2, 8, seed=6, S=3))
    with pytest.raises(ValueError, match="cifg_states"):
        cifg_states(zx[:, :, :-1], h0, c0, w)
    with pytest.raises(ValueError, match="cell"):
        cifg_states(zx, h0, c0, w, cell="ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cell_rows_do_not_depend_on_batch(dtype):
    """The engine (B = slots) and the reference (B = 1) must agree bit for
    bit: each row of a B=300 step equals the same row stepped alone."""
    zx, h, c, w = _t(*_inputs(300, 32, seed=7))
    w = w.to(getattr(torch, dtype))
    hb, cb = cifg_step(zx, h, c, w)
    for r in (0, 5, 255, 299):
        h1, c1 = cifg_step(zx[r:r + 1], h[r:r + 1], c[r:r + 1], w)
        assert torch.equal(h1[0], hb[r]) and torch.equal(c1[0], cb[r])


def test_rowstable_mm_matches_mm_and_is_row_stable():
    rng = np.random.default_rng(8)
    a = torch.from_numpy(rng.standard_normal((ROW_TILE + 44, 40))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    full = rowstable_mm(a, b)
    torch.testing.assert_close(full, a @ b, atol=1e-5, rtol=1e-5)
    for r in (0, 3, ROW_TILE - 1, ROW_TILE, ROW_TILE + 43):
        assert torch.equal(rowstable_mm(a[r:r + 1], b)[0], full[r])
    with pytest.raises(ValueError):
        rowstable_mm(a, b[:-1])


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()


def test_kernel_library_path_tracks_the_source():
    p = build.library_path("cifg_cell_fwd")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert p == build.library_path("cifg_cell_fwd")   # stable
    assert set(build.SOURCES) == {"cifg_cell_fwd", "cifg_cell_bwd", "dp_clip",
                                  "flash_attention_fwd", "ssd_scan"}
    for name in build.SOURCES:
        assert build.library_path(name).name.startswith(f"lib{name}-")
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])
