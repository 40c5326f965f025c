"""Mamba-2 (arXiv:2405.21060) in plain PyTorch, with the plain chunked SSD:
a frozen copy of the model's equations, independent of the port.

A layer: ``h = rmsnorm(x)``; ``z, x', B, C = h W_z, h W_x, h W_B, h W_C``
and ``dt = softplus(h W_dt + dt_bias)``; ``x', B, C`` each through a
depthwise causal convolution of width W and SiLU; the SSD scan
``h_t = e^{A dt_t} h_{t−1} + dt_t B_t ⊗ x_t``, ``y_t = C_t h_t`` per head
with ``A = −exp(A_log)``, plus ``D x``; ``y · silu(z)``, rmsnorm, ``W_out``,
and the residual. Then the final rmsnorm and the tied head over the padded
vocabulary. The scan is computed in chunks of 128 tokens (the dual
quadratic form within a chunk, the carried state across chunks), which is
the recurrence's exact value in other order.

Parameters are laid out as the port lays them out (layers stacked on a
leading axis), so the benchmark hands one set to both.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.precision import cast

CHUNK = 128
EPS = 1e-6


def pad_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def init(model: dict, init_cfg: dict, generator: torch.Generator) -> dict:
    """Random weights on the generator's device, one call a stacked leaf:
    the embedding N(0, ``embed_std``²), the matrices and conv taps
    truncated normals of fan-in scale, ``dt_bias`` the inverse softplus of
    a log-uniform step in [1e-3, 0.1], ``A_log = log(1..H)``, D 1, norms
    1, biases 0."""
    d, n = model["d_model"], model["n_layers"]
    di, N, H = model["ssm_expand"] * d, model["ssm_state"], model["ssm_heads"]
    W = model["ssm_conv_width"]
    dev = generator.device

    def dense(shape, fan_in):
        std = 1.0 / math.sqrt(fan_in)
        w = torch.empty((n,) + shape, dtype=torch.float32, device=dev)
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)

    def const(v, size):
        return torch.full((n, size), v, dtype=torch.float32, device=dev)

    u = torch.rand((n, H), generator=generator, dtype=torch.float32,
                   device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    emb = torch.randn((pad_vocab(model["vocab"]), d), generator=generator,
                      dtype=torch.float32, device=dev) * init_cfg["embed_std"]
    return {
        "embed": {"tok": emb},
        "layers": {
            "ln": {"scale": const(1.0, d)},
            "mixer": {
                "w_z": dense((d, di), d), "w_x": dense((d, di), d),
                "w_B": dense((d, N), d), "w_C": dense((d, N), d),
                "w_dt": dense((d, H), d),
                "conv_x": dense((W, di), W), "conv_B": dense((W, N), W),
                "conv_C": dense((W, N), W),
                "conv_b_x": const(0.0, di), "conv_b_B": const(0.0, N),
                "conv_b_C": const(0.0, N),
                "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                                device=dev)).expand(n, H)
                .contiguous(),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                "D": const(1.0, H),
                "norm": {"scale": const(1.0, di)},
                "w_out": dense((di, d), di)}},
        "ln_f": {"scale": torch.ones((d,), dtype=torch.float32, device=dev)},
    }


def rmsnorm(x, w):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + EPS) * w


def _conv(seq, w, b):
    """Depthwise causal conv of (B, S, C) with taps (W, C), then SiLU."""
    W = w.shape[0]
    out = seq * w[W - 1]
    for i in range(W - 1):
        shift = W - 1 - i
        out = out + F.pad(seq, (0, 0, shift, 0))[:, :-shift] * w[i]
    return F.silu(out + b)


def ssd(x, dt, Bm, Cm, A):
    """x (B, S, H, p), dt (B, S, H), B and C (B, S, N), A (H,) → y (B, S,
    H, p), from a zero state, chunk by chunk."""
    Bsz, S, H, p = x.shape
    Q = min(CHUNK, S)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    h = torch.zeros((Bsz, H, p, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        bc, cc = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        cum = torch.cumsum(dtc * A, dim=1)                     # (B,Q,H)
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,Q,Q,H)
        Lmat = torch.exp(seg.masked_fill(~tri[None, :, :, None],
                                         float("-inf")))
        w = (torch.einsum("bqn,bsn->bqs", cc, bc)[..., None] * Lmat
             * dtc[:, None, :, :])
        y = torch.einsum("bqsh,bshp->bqhp", w, xc) + torch.exp(cum)[
            ..., None] * torch.einsum("bqn,bhpn->bqhp", cc, h)
        dB = (dtc * torch.exp(cum[:, -1:] - cum))[..., None] * bc[:, :, None]
        h = (torch.exp(cum[:, -1])[:, :, None, None] * h
             + torch.einsum("bqhn,bqhp->bhpn", dB, xc))
        ys.append(y)
    return torch.cat(ys, dim=1)


def _layer(x, lp, model, prec):
    """One layer. ``q`` rounds a value to ``prec`` where the stated compute
    dtype holds it: the residual stream, each product's operands and
    output, the norms' and the convolutions' outputs, the gated output."""
    d = model["d_model"]
    di, H = model["ssm_expand"] * d, model["ssm_heads"]
    m = lp["mixer"]

    def q(t):
        return cast(t, prec)

    hin = q(rmsnorm(x, lp["ln"]["scale"]))

    def proj(name):
        return q(hin @ q(m[name]))

    z, xr, Br, Cr = proj("w_z"), proj("w_x"), proj("w_B"), proj("w_C")
    dt = F.softplus(proj("w_dt") + m["dt_bias"])
    xs = q(_conv(xr, q(m["conv_x"]), m["conv_b_x"]))
    Bc = q(_conv(Br, q(m["conv_B"]), m["conv_b_B"]))
    Cc = q(_conv(Cr, q(m["conv_C"]), m["conv_b_C"]))
    Bsz, S = x.shape[:2]
    xh = xs.reshape(Bsz, S, H, di // H)
    y = ssd(xh, dt, Bc, Cc, -torch.exp(m["A_log"])) + m["D"][:, None] * xh
    y = q(q(y.reshape(Bsz, S, di)) * F.silu(z))
    y = q(rmsnorm(y, m["norm"]["scale"]))
    return q(x + q(y @ q(m["w_out"])))


def logits(p, tokens, model, prec):
    """tokens (B, S) → logits (B, S, Vpad) float32."""
    x = cast(p["embed"]["tok"][tokens], prec)
    lay = p["layers"]
    for i in range(model["n_layers"]):
        lp = {"ln": {"scale": lay["ln"]["scale"][i]},
              "mixer": {k: ({"scale": v["scale"][i]} if isinstance(v, dict)
                            else v[i]) for k, v in lay["mixer"].items()}}
        x = _layer(x, lp, model, prec)
    x = cast(rmsnorm(x, p["ln_f"]["scale"]), prec)
    return cast(x @ cast(p["embed"]["tok"], prec).t(), prec)


def loss(p, tokens, labels, mask, model, prec):
    """Masked next-token cross-entropy over the published vocabulary."""
    lg = logits(p, tokens, model, prec)
    cols = torch.arange(lg.shape[-1], device=lg.device)
    lg = lg.masked_fill(cols >= model["vocab"], float("-inf"))
    nll = torch.logsumexp(lg, -1) - lg.gather(-1, labels[..., None].long()
                                              )[..., 0]
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def client_losses(p, tokens, labels, mask, model: dict, prec: str):
    """`loss` of each client of a chunk, one after another: every leaf of
    ``p`` and the batch (C, B, S) carry a leading client axis → (C,)."""
    from port_bench.reference.tree import tmap
    return torch.stack([
        loss(tmap(lambda l, c=c: l[c], p), tokens[c], labels[c], mask[c],
             model, prec) for c in range(tokens.shape[0])])


def forward_flops_per_token(model: dict, seq_len: int) -> float:
    """Operations of one position's forward: per layer the five input
    projections, the output projection, the convolutions and the chunked
    SSD (C·Bᵀ on the chunk's lower triangle, once for all heads; per head
    the triangle's product with x, the state update and C times the
    carried state), and the tied head over the published vocabulary (two
    per multiply-add)."""
    d, N, H = model["d_model"], model["ssm_state"], model["ssm_heads"]
    di, W = model["ssm_expand"] * d, model["ssm_conv_width"]
    p = di // H
    Q = min(CHUNK, seq_len)
    tri = (Q + 1) / 2.0
    proj = d * (2 * di + 2 * N + H) + di * d
    conv = W * (di + 2 * N)
    scan = tri * N + H * (tri * p + 2 * N * p)
    return 2.0 * (model["n_layers"] * (proj + conv + scan)
                  + d * model["vocab"])


def train_flops_per_token(model: dict, seq_len: int) -> float:
    """Forward plus backward at three times the forward, with no
    rematerialised recompute."""
    return 3.0 * forward_flops_per_token(model, seq_len)
