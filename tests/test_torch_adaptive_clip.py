"""The port's adaptive clipping (`repro_torch.core.adaptive_clip`) against
the reference's ``repro.core.adaptive_clip``.

With ``noise_multiplier_b = 0`` both are deterministic, and the port's
S_t trajectory is held against the reference's to 1e-6 relative (float32
exp and the fraction's mean in another order). With noise, the draws come
from a ``torch.Generator`` (the reference splits a JAX key), so the noise
is held in distribution: over 4,000 draws the std of the noisy fraction,
read back from S_t+1 / S_t, is z_b / n within 5% (the sample std of 4,000
normal draws has a relative standard error of 1.1%), its mean within 5
standard errors of the exact fraction; one generator seed gives one
trajectory.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive_clip as J
from repro_torch.core.adaptive_clip import (adaptive_rounds,
                                            init_adaptive_clip,
                                            update_clip_norm)


def _norms(seed, rounds=60, n=50, shrink=0.0):
    rng = np.random.default_rng(seed)
    return [(rng.lognormal(0.0, 0.5, n) * (1.0 - shrink * t)
             ).astype(np.float32) for t in range(rounds)]


@pytest.mark.parametrize("start,quantile,lr,shrink", [
    (0.05, 0.9, 0.3, 0.0), (2.0, 0.5, 0.3, 0.004), (0.8, 0.9, 0.2, 0.0)])
def test_noiseless_trajectory_matches_jax(start, quantile, lr, shrink):
    norms = _norms(int(start * 100), shrink=shrink)
    kw = dict(initial_clip=start, target_quantile=quantile, lr=lr,
              noise_multiplier_b=0.0)
    jstate, want = J.adaptive_rounds(norms, 50, jax.random.PRNGKey(0),
                                     J.init_adaptive_clip(**kw))
    state, got = adaptive_rounds(norms, 50, torch.Generator().manual_seed(0),
                                 init_adaptive_clip(**kw, device="cpu"))
    assert len(got) == len(want) == len(norms) + 1
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert state.clip_norm.dtype == torch.float32
    assert (state.target_quantile, state.lr, state.noise_multiplier_b) == \
        (jstate.target_quantile, jstate.lr, jstate.noise_multiplier_b)


def test_one_noiseless_update_matches_jax():
    js = J.update_clip_norm(J.init_adaptive_clip(noise_multiplier_b=0.0),
                            jnp.asarray(0.7, jnp.float32), 100,
                            jax.random.PRNGKey(3))
    s = update_clip_norm(init_adaptive_clip(noise_multiplier_b=0.0,
                                            device="cpu"),
                         torch.tensor(0.7), 100, torch.Generator())
    np.testing.assert_allclose(float(s.clip_norm), float(js.clip_norm),
                               rtol=1e-6)


def test_noise_std_is_zb_over_n():
    zb, n, lr, frac, draws = 10.0, 100, 0.2, 0.7, 4000
    state = init_adaptive_clip(initial_clip=1.0, target_quantile=0.9, lr=lr,
                               noise_multiplier_b=zb, device="cpu")
    gen = torch.Generator().manual_seed(11)
    noisy = []
    for _ in range(draws):
        s = update_clip_norm(state, torch.tensor(frac), n, gen)
        # S' / S = exp(-lr (noisy - γ))  =>  noisy = γ - log(S'/S) / lr
        noisy.append(0.9 - float(torch.log(s.clip_norm)) / lr)
    noisy = np.asarray(noisy)
    sigma = zb / n
    assert abs(noisy.std() / sigma - 1) < 0.05, noisy.std()
    assert abs(noisy.mean() - frac) < 5 * sigma / np.sqrt(draws)


def test_a_seed_gives_one_trajectory_and_the_noise_moves_it():
    norms = _norms(4, rounds=20)
    state = init_adaptive_clip(noise_multiplier_b=1.0, device="cpu")
    a = adaptive_rounds(norms, 50, torch.Generator().manual_seed(5), state)[1]
    b = adaptive_rounds(norms, 50, torch.Generator().manual_seed(5), state)[1]
    c = adaptive_rounds(norms, 50, torch.Generator().manual_seed(6), state)[1]
    assert a == b and a != c


def test_init_defaults_to_cuda():
    """With no device the state goes to the card: without one, it raises
    rather than falling back to the host."""
    if torch.cuda.is_available():
        assert init_adaptive_clip().clip_norm.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            init_adaptive_clip()
