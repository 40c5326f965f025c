"""The port's SSD scan (`repro_torch.kernels.ssd_scan`) on the CPU: the
wrapper (which pads S to the chunk with dt = 0 and computes the plain chunked
form there), the plain chunked form `ssd_chunked` and the sequential
recurrence `ssd_scan_ref`, against the JAX package's Pallas kernel in
interpret mode, its ``ssd_scan_ref`` and the JAX model's
``mamba2.ssd_chunked``, on the same inputs made with numpy. Both y and the
final state are compared. The CUDA kernel is held against the plain version
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance 1e-4 (atol = rtol), the JAX test's: float32 sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import (LAUNCHES, ssd_chunked, ssd_scan,
                                          ssd_scan_ref)

TOL = dict(rtol=1e-4, atol=1e-4)
GRID = [(2, 256, 4, 64, 32), (1, 128, 2, 32, 16), (1, 384, 3, 16, 8),
        (1, 200, 2, 64, 64)]  # the JAX test's grid; S = 200 is unpadded


def _inputs(B, S, H, p, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, p))
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.1
    Bm, Cm = rng.standard_normal((2, B, S, N))
    A = -np.exp(rng.standard_normal(H))
    return [a.astype(np.float32) for a in (x, dt, Bm, Cm, A)]


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("B,S,H,p,N", GRID)
def test_wrapper_matches_jax_kernel_and_oracle(B, S, H, p, N):
    arrays = _inputs(B, S, H, p, N, seed=S + N)
    before = LAUNCHES["ssd_scan"]
    got = ssd_scan(*(torch.from_numpy(a) for a in arrays))
    assert LAUNCHES["ssd_scan"] == before        # no kernel on the CPU
    assert got[0].shape == (B, S, H, p) and got[1].shape == (B, H, p, N)
    _close(got, jax_ssd_scan(*arrays))
    _close(got, jax_ssd_ref(*arrays))


@pytest.mark.parametrize("B,S,H,p,N", GRID)
def test_sequential_recurrence_matches_jax(B, S, H, p, N):
    arrays = _inputs(B, S, H, p, N, seed=S + N + 1)
    _close(ssd_scan_ref(*(torch.from_numpy(a) for a in arrays)),
           jax_ssd_ref(*arrays))


@pytest.mark.parametrize("B,S,H,p,N", [g for g in GRID if g[1] != 200]
                         + [(2, 64, 3, 16, 8)])
def test_chunked_form_from_a_carried_state_matches_jax(B, S, H, p, N):
    x, dt, Bm, Cm, A = _inputs(B, S, H, p, N, seed=S + N + 2)
    h0 = np.random.default_rng(S).standard_normal(
        (B, H, p, N)).astype(np.float32)
    got = ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, Bm, Cm, A,
                                                      h0)))
    _close(got, jax_ssd_chunked(x, dt, Bm, Cm, A, h0))
    _close(got, jax_ssd_ref(x, dt, Bm, Cm, A, h0))


def test_chunked_form_refuses_what_the_reference_refuses():
    x, dt, Bm, Cm, A = (torch.from_numpy(a) for a in _inputs(1, 200, 2, 8, 4))
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_chunked(x, dt, Bm, Cm, A, torch.zeros((1, 2, 8, 4)))
    with pytest.raises(AssertionError):
        jax_ssd_chunked(*(t.numpy() for t in (x, dt, Bm, Cm, A)),
                        np.zeros((1, 2, 8, 4), np.float32))


def test_wrapper_checks_shapes():
    x, dt, Bm, Cm, A = (torch.from_numpy(a) for a in _inputs(1, 128, 2, 8, 4))
    with pytest.raises(ValueError, match="expected dt"):
        ssd_scan(x, dt[:, :, :1], Bm, Cm, A)
    with pytest.raises(ValueError, match="expected Cm"):
        ssd_scan(x, dt, Bm, Cm[..., :2], A)
    with pytest.raises(ValueError, match="expected A"):
        ssd_scan(x, dt, Bm, Cm, A[:1])
    with pytest.raises(TypeError, match="floating"):
        ssd_scan(x, dt, Bm.long(), Cm, A)
