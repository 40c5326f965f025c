"""Mamba-2 / SSD (state-space duality) blocks [arXiv:2405.21060] — mamba2-370m.

The port of ``repro.models.mamba2``. The prefill and forward path runs the
chunked SSD algorithm through `repro_torch.kernels.ssd_scan.ssd_scan`, which
launches the hand-written scan kernel for CUDA tensors and computes the
plain chunked form (`repro_torch.kernels.ssd_scan.ssd_chunked`) on the CPU.
The decode path is the O(1) recurrence. The state is kept in float32.

Layout: d_inner = expand·d_model; H = ssm_heads, p = head_dim, N =
ssm_state; a single B/C group. The input projection is stored as separate
z/x/B/C/dt matrices and the depthwise conv per segment, as in the reference,
and the layers' parameters are stacked with a leading ``(n_layers, …)`` axis,
so the reference's parameter tree crosses over as it is
(`repro_torch.utils.params.from_jax_params`).

Weights: a parameter set with compute-dtype copies (``params["compute"]``,
made once by `repro_torch.utils.params`) computes with them; without them
each product casts its weight (`_weights`).
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import CHUNK
from repro_torch.models import layers as L
from repro_torch.models.api import Model
from repro_torch.models.embed import embed_tokens, embedding_init
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import torch_dtype
from repro_torch.utils.params import (COMPUTE, matrix_copies,
                                      with_compute_copies)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm_expand * cfg.d_model


def mixer_init(generator: torch.Generator, cfg: ModelConfig, *,
               n_layers: int, device=None):
    """Mixer parameters of ``n_layers`` layers, stacked (leading axis
    ``n_layers``), drawn in one call per leaf."""
    di, N, H = d_inner(cfg), cfg.ssm_state, cfg.ssm_heads
    W, d = cfg.ssm_conv_width, cfg.d_model
    n = n_layers

    def dense(shape, in_dim):
        return L.dense_init(generator, (n,) + shape, in_dim=in_dim,
                            device=device)

    u = torch.rand((n, H), generator=generator, dtype=torch.float32,
                   device=generator.device).to(device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))     # inverse softplus

    def const(v):
        return v.to(device).expand(n, *v.shape).contiguous()

    return {
        "w_z": dense((d, di), d),
        "w_x": dense((d, di), d),
        "w_B": dense((d, N), d),
        "w_C": dense((d, N), d),
        "w_dt": dense((d, H), d),
        "conv_x": dense((W, di), W),
        "conv_B": dense((W, N), W),
        "conv_C": dense((W, N), W),
        "conv_b_x": const(torch.zeros((di,))),
        "conv_b_B": const(torch.zeros((N,))),
        "conv_b_C": const(torch.zeros((N,))),
        "A_log": const(torch.log(torch.arange(1, H + 1, dtype=torch.float32))),
        "dt_bias": dt_bias,
        "D": const(torch.ones((H,))),
        "norm": L.stacked_norm_init(n, di, "rmsnorm", device=device),
        "w_out": dense((di, d), di),
    }


def layers_init(generator: torch.Generator, cfg: ModelConfig, n_layers: int,
                *, device=None):
    """``n_layers`` stacked Mamba-2 layers: pre-norm and mixer."""
    return {"ln": L.stacked_norm_init(n_layers, cfg.d_model, "rmsnorm",
                                      device=device),
            "mixer": mixer_init(generator, cfg, n_layers=n_layers,
                                device=device)}


def layer_params(stacked, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copy)."""
    if isinstance(stacked, dict):
        return {k: layer_params(v, i) for k, v in stacked.items()}
    return stacked[i]


def _causal_conv(seq, w, b):
    """Depthwise causal conv via shifted adds. seq: (B,S,C); w: (W,C)."""
    W = w.shape[0]
    out = seq * w[W - 1][None, None, :]
    for i in range(W - 1):
        shift = W - 1 - i
        shifted = F.pad(seq, (0, 0, shift, 0))[:, :-shift, :]
        out = out + shifted * w[i][None, None, :]
    return F.silu(out + b[None, None, :].to(seq.dtype))


def _proj(x, p):
    """x: (B,S,d) → z (B,S,di), x_raw (B,S,di), B_raw, C_raw (B,S,N),
    dt (B,S,H) float32 after the softplus."""
    z = L.matmul(x, p["w_z"])
    x_raw = L.matmul(x, p["w_x"])
    B_raw = L.matmul(x, p["w_B"])
    C_raw = L.matmul(x, p["w_C"])
    dt = F.softplus(L.matmul(x, p["w_dt"]).float()
                    + p["dt_bias"][None, None, :])
    return z, x_raw, B_raw, C_raw, dt


def mixer_fwd(x, p, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence mixer. x: (B,S,d) in the compute dtype."""
    di, H = d_inner(cfg), cfg.ssm_heads
    hp = di // H
    Bsz, S, _ = x.shape
    # the reference's contract (ssd_chunked asserts S % min(CHUNK, S) == 0),
    # held on every device although the kernel would pad such lengths
    if S % min(CHUNK, S):
        raise ValueError(f"sequence length {S} is not a multiple of the SSD "
                         f"chunk {CHUNK} (lengths below {CHUNK} are taken "
                         f"as one chunk)")
    cd = x.dtype
    z, x_raw, B_raw, C_raw, dt = _proj(x, p)
    xs = _causal_conv(x_raw, p["conv_x"].to(cd), p["conv_b_x"])
    Bc = _causal_conv(B_raw, p["conv_B"].to(cd), p["conv_b_B"])
    Cc = _causal_conv(C_raw, p["conv_C"].to(cd), p["conv_b_C"])
    xh = xs.reshape(Bsz, S, H, hp)
    A = -torch.exp(p["A_log"])
    y, h_fin = ssd_scan(xh, dt, Bc, Cc, A)
    y = y + p["D"][None, None, :, None] * xh.float()
    y = y.to(cd).reshape(Bsz, S, di)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"]["scale"])
    out = L.matmul(y, p["w_out"])
    if return_state:
        W = cfg.ssm_conv_width
        tails = (x_raw[:, -(W - 1):, :], B_raw[:, -(W - 1):, :],
                 C_raw[:, -(W - 1):, :])
        return out, h_fin, tails
    return out


def mixer_step(x, p, cfg: ModelConfig, h, conv_state):
    """One-token recurrence. x: (B,1,d); h: (B,H,p,N) float32; conv_state:
    (cx (B,W-1,di), cB (B,W-1,N), cC (B,W-1,N)) raw history."""
    di, H = d_inner(cfg), cfg.ssm_heads
    hp = di // H
    Bsz = x.shape[0]
    cd = x.dtype
    z, x_raw, B_raw, C_raw, dt = _proj(x, p)
    cx, cB, cC = conv_state

    def conv1(hist, new, w, b):
        full = torch.cat([hist.to(cd), new], dim=1)               # (B,W,C)
        out = (full.float() * w.to(cd).float()[None]).sum(dim=1).to(cd)
        return F.silu(out + b.to(cd)), full[:, 1:, :]

    xs, cx_new = conv1(cx, x_raw, p["conv_x"], p["conv_b_x"])
    Bc, cB_new = conv1(cB, B_raw, p["conv_B"], p["conv_b_B"])
    Cc, cC_new = conv1(cC, C_raw, p["conv_C"], p["conv_b_C"])
    xh = xs.reshape(Bsz, H, hp)
    A = -torch.exp(p["A_log"])
    dts = dt[:, 0, :]                                            # (B,H)
    decay = torch.exp(dts * A[None, :])
    dBx = torch.einsum("bh,bn,bhp->bhpn", dts, Bc.float(), xh.float())
    h_new = decay[:, :, None, None] * h + dBx
    y = torch.einsum("bn,bhpn->bhp", Cc.float(), h_new)
    y = y + p["D"][None, :, None] * xh.float()
    y = y.to(cd).reshape(Bsz, 1, di)
    y = y * F.silu(z)
    y = L.rmsnorm(y, p["norm"]["scale"])
    out = L.matmul(y, p["w_out"])
    return out, h_new, (cx_new, cB_new, cC_new)


# ------------------------------------------------------------ the model


def _weights(params):
    """The tree the products read: the compute copies when ``params``
    carries them, else ``params`` itself (each product then casts)."""
    return params.get(COMPUTE, params)


def _tokens(params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["ln_f"]["scale"].device
                           ).long()


def logits(cw, x) -> torch.Tensor:
    """x: (B,S,d) → (B,S,Vpad) float32 against the tied (or separate) head
    in x's dtype. On the CPU the float32 product of those values, as the
    reference's ``preferred_element_type=float32``; on the card one product
    in x's dtype (float32 sums, the output rounded to x's dtype)."""
    emb = cw["embed"]
    w = emb.get("head", emb["tok"]).to(x.dtype)
    if x.device.type == "cpu":
        return x.float() @ w.float().t()
    return (x @ w.t()).float()


# a compute-dtype mirror of every per-layer matrix; "layers" leaves carry
# the stacked layer axis
compute_copies = partial(matrix_copies, stacked=("layers",))


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` on its own device, then
    moved to ``device``, with the compute-dtype copies made."""
    dev = resolve_device(device)
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        "layers": layers_init(generator, cfg, cfg.n_layers, device=dev),
        "ln_f": L.norm_init(cfg.d_model, "rmsnorm", device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    del remat   # the port runs no training of this family yet
    cd = torch_dtype(cfg.compute_dtype)
    cw = _weights(params)
    x = embed_tokens(cw["embed"], _tokens(params, batch["tokens"]), cd)
    caches = []
    for i in range(cfg.n_layers):
        lp = layer_params(cw["layers"], i)
        h = L.norm(x, lp["ln"], "rmsnorm")
        if collect_cache:
            out, h_fin, tails = mixer_fwd(h, lp["mixer"], cfg,
                                          return_state=True)
            caches.append((h_fin, tails))
        else:
            out = mixer_fwd(h, lp["mixer"], cfg)
        x = x + out
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    out = logits(cw, x)
    return (out, caches) if collect_cache else out


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    out = forward(params, batch, cfg, remat=remat)
    return L.lm_loss(out, batch["labels"], cfg.vocab, batch.get("mask"))


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    del max_len   # recurrent state: nothing grows with the length
    dev = resolve_device(device)
    di, N, H = d_inner(cfg), cfg.ssm_state, cfg.ssm_heads
    W, Lr = cfg.ssm_conv_width, cfg.n_layers
    cd = torch_dtype(cfg.compute_dtype)
    return {
        "ssm": torch.zeros((Lr, batch_size, H, di // H, N),
                           dtype=torch.float32, device=dev),
        "conv_x": torch.zeros((Lr, batch_size, W - 1, di), dtype=cd,
                              device=dev),
        "conv_B": torch.zeros((Lr, batch_size, W - 1, N), dtype=cd,
                              device=dev),
        "conv_C": torch.zeros((Lr, batch_size, W - 1, N), dtype=cd,
                              device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def stack_caches(caches, cd):
    """[(h_fin, (cx, cB, cC)) per layer] → the stacked cache leaves."""
    return {"ssm": torch.stack([c[0] for c in caches]),
            "conv_x": torch.stack([c[1][0] for c in caches]).to(cd),
            "conv_B": torch.stack([c[1][1] for c in caches]).to(cd),
            "conv_C": torch.stack([c[1][2] for c in caches]).to(cd)}


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    del max_len   # recurrent state: no KV to pad
    out, caches = forward(params, batch, cfg, collect_cache=True)
    cache = stack_caches(caches, torch_dtype(cfg.compute_dtype))
    cache["pos"] = torch.tensor(out.shape[1], dtype=torch.int32,
                                device=out.device)
    return out[:, -1, :], cache


def decode_step(params, tokens, cache, cfg: ModelConfig):
    cd = torch_dtype(cfg.compute_dtype)
    cw = _weights(params)
    x = embed_tokens(cw["embed"], _tokens(params, tokens)[:, None], cd)
    new = {"ssm": [], "conv_x": [], "conv_B": [], "conv_C": []}
    for i in range(cfg.n_layers):
        lp = layer_params(cw["layers"], i)
        hin = L.norm(x, lp["ln"], "rmsnorm")
        out, h_new, conv = mixer_step(
            hin, lp["mixer"], cfg, cache["ssm"][i],
            (cache["conv_x"][i], cache["conv_B"][i], cache["conv_C"][i]))
        x = x + out
        new["ssm"].append(h_new)
        for k, c in zip(("conv_x", "conv_B", "conv_C"), conv):
            new[k].append(c.to(cd))
    x = L.norm(x, cw["ln_f"], "rmsnorm")
    out = logits(cw, x)[:, 0, :]
    new = {k: torch.stack(v) for k, v in new.items()}
    new["pos"] = cache["pos"] + 1
    return out, new


def build(cfg: ModelConfig) -> Model:
    return Model(
        cfg=cfg,
        init=partial(init, cfg=cfg),
        forward=partial(forward, cfg=cfg),
        loss_fn=partial(loss_fn, cfg=cfg),
        init_cache=partial(init_cache, cfg),
        prefill=partial(prefill, cfg=cfg),
        decode_step=partial(decode_step, cfg=cfg),
        compute_copies=compute_copies,
    )
