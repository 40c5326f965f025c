"""The port's flash attention (`repro_torch.kernels.flash_attention`) on the
CPU, where its wrapper computes the plain version, against the JAX package's
Pallas kernel in interpret mode (``repro.kernels.flash_attention``, as
``tests/test_kernels.py`` runs it) and its oracle ``attention_ref``, on the
same inputs made with numpy. The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances are the JAX test's: 1e-5 in float32 (sums in another order),
2e-2 in bfloat16 (both round a float32 result once, after different sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import (LAUNCHES, flash_attention,
                                                 flash_attention_ref)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _inputs(B, Sq, Sk, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def _jax_ref(q, k, v, causal, window):
    G = q.shape[2] // k.shape[2]
    kr = jnp.repeat(k.transpose(0, 2, 1, 3), G, axis=1)
    vr = jnp.repeat(v.transpose(0, 2, 1, 3), G, axis=1)
    return attention_ref(q.transpose(0, 2, 1, 3), kr, vr, causal=causal,
                         window=window).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (2, 256, 256, 4, 2, 64),
    (1, 100, 100, 2, 1, 32),     # unpadded
    (1, 130, 130, 4, 4, 80),     # zamba2's head dim, ragged S
    (1, 130, 130, 2, 2, 160),    # stablelm-12b's head dim (the wide route)
    (1, 96, 96, 2, 1, 256),
    (1, 80, 80, 8, 2, 64),       # granite-3-2b's GQA 4:1 at hd 64
    (1, 80, 80, 2, 2, 128),      # olmoe-1b-7b's MHA at hd 128
])
def test_plain_version_matches_jax(B, Sq, Sk, H, KV, hd, causal, window,
                                   dtype):
    arrays = _inputs(B, Sq, Sk, H, KV, hd, seed=hd)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in arrays)
    before = LAUNCHES["flash_attention_fwd"]
    out = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert LAUNCHES["flash_attention_fwd"] == before   # no kernel on the CPU
    assert out.dtype == tq.dtype and out.shape == tq.shape
    got = out.float().numpy()
    tol = TOL[dtype]
    for want in (jax_flash(jq, jk, jv, causal=causal, window=window),
                 _jax_ref(jq, jk, jv, causal, window)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_window_without_causal_mask():
    """Bidirectional with a window keeps keys k > q - window on both sides of
    the diagonal."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 40, 2, 2, 16, 3))
    out = flash_attention(q, k, v, causal=False, window=8)
    jq, jk, jv = (jnp.asarray(t.numpy()) for t in (q, k, v))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(_jax_ref(jq, jk, jv, False, 8)),
                               rtol=1e-5, atol=1e-5)


def test_row_without_a_valid_key_is_zero():
    """A query row that no key may see gives 0 (the kernel's l == 0 guard),
    rows with keys are the softmax average."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 12, 4, 2, 1, 8, 4))
    out = flash_attention_ref(q, k, v, causal=False, window=2)
    assert torch.count_nonzero(out[:, 5:]) == 0      # rows 5.. see no key < 4
    assert torch.count_nonzero(out[:, :5]) > 0


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                        v[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(TypeError, match="q is"):
        flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(q, k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_path_moves_neither_launch_counter(dtype):
    """Both counters, the tensor-core one included, count kernel launches
    only; on the CPU the wrapper is the plain version in either dtype."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype))
               for a in _inputs(1, 70, 70, 4, 2, 80, 5))
    before = dict(LAUNCHES)
    assert set(before) == {"flash_attention_fwd", "flash_attention_fwd_tc"}
    out = flash_attention(q, k, v, causal=True)
    assert LAUNCHES == before
    assert torch.equal(out, flash_attention_ref(q, k, v, causal=True))
