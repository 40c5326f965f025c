"""The paper's CIFG-LSTM (§III-A) in plain PyTorch: a frozen copy of the
model's equations, independent of the port.

One layer, a tied embedding of ``d_model`` (padded to a multiple of 256
rows), a CIFG cell of ``d_ff`` units with the forget bias 1:
``z = x_t W_x + b + h W_h``, ``f = σ(z_f + 1)``, ``o = σ(z_o)``,
``g = tanh(z_g)``, ``c' = f c + (1 − f) g``, ``h' = o tanh(c')``; then
``y = h W_proj`` and the logits ``y E^T`` over the padded vocabulary. The
training loss masks the padded columns and the padding labels; the Secret
Sharer's score takes the log-softmax over every padded column, as the
port's scorer defines it.

Parameters are laid out as the port lays them out (``embed/tok``,
``w_x``, ``w_h``, ``b_gates``, ``w_proj``), so the benchmark hands one
set to both. `precision.cast` rounds a value where the stated compute
dtype holds it (the embedded row, each product's operands, the input
projection and the output projection), as the port rounds them.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference.precision import cast

PAD = 0


def pad_vocab(vocab: int) -> int:
    return -(-vocab // 256) * 256


def _trunc_normal(generator, shape, fan_in):
    std = 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                       generator=generator)


def init(model: dict, init_cfg: dict, generator: torch.Generator) -> dict:
    """Random weights on the generator's device, one call a leaf: the
    embedding N(0, ``embed_std``²), the matrices truncated normals of
    fan-in scale, the gate bias 0."""
    d, h, v = model["d_model"], model["d_ff"], pad_vocab(model["vocab"])
    emb = torch.randn((v, d), generator=generator, dtype=torch.float32,
                      device=generator.device) * init_cfg["embed_std"]
    return {"embed": {"tok": emb},
            "w_x": _trunc_normal(generator, (d, 3 * h), d + h),
            "w_h": _trunc_normal(generator, (h, 3 * h), d + h),
            "b_gates": torch.zeros((3 * h,), dtype=torch.float32,
                                   device=generator.device),
            "w_proj": _trunc_normal(generator, (h, d), h)}


def _cell(z, c, H):
    f = torch.sigmoid(z[..., :H] + 1.0)
    o = torch.sigmoid(z[..., H:2 * H])
    g = torch.tanh(z[..., 2 * H:])
    c = f * c + (1.0 - f) * g
    return o * torch.tanh(c), c


def _hidden(p, tokens, prec, steps=None):
    """tokens (C, B, S) with per-client parameters (every leaf (C, …)) →
    hidden states (C, B, steps, H) of the first ``steps`` positions."""
    C, B, S = tokens.shape
    steps = S if steps is None else steps
    tok = p["embed"]["tok"]
    H = p["w_h"].shape[-2]
    x = tok[torch.arange(C, device=tokens.device)[:, None, None],
            tokens[:, :, :steps]]
    zx = cast(torch.bmm(cast(x.reshape(C, B * steps, -1), prec),
                        cast(p["w_x"], prec)), prec).reshape(C, B, steps,
                                                            3 * H)
    zx = zx + p["b_gates"][:, None, None, :]
    w_h = cast(p["w_h"], prec)
    h = torch.zeros((C, B, H), dtype=torch.float32, device=tokens.device)
    c = torch.zeros_like(h)
    hs = []
    for t in range(steps):
        h, c = _cell(zx[:, :, t] + torch.bmm(cast(h, prec), w_h), c, H)
        hs.append(h)
    return torch.stack(hs, dim=2)


def _logits(p, hs, prec):
    """hs (C, M, H) → logits (C, M, Vpad) float32."""
    y = cast(torch.bmm(cast(hs, prec), cast(p["w_proj"], prec)), prec)
    return torch.bmm(y, cast(p["embed"]["tok"], prec).transpose(1, 2))


def client_losses(p, tokens, labels, mask, model: dict, prec: str):
    """Masked next-word cross-entropy of each client: tokens, labels and
    mask (C, B, S), parameters with a leading client axis → (C,)."""
    C, B, S = tokens.shape
    vocab = model["vocab"]
    hs = _hidden(p, tokens, prec)
    logits = _logits(p, hs.reshape(C, B * S, -1), prec)
    cols = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(cols >= vocab, float("-inf"))
    nll = (torch.logsumexp(logits, -1)
           - logits.gather(-1, labels.reshape(C, B * S, 1).long())[..., 0])
    m = mask.reshape(C, B * S).float()
    return (nll * m).sum(-1) / m.sum(-1).clamp(min=1.0)


def scores(p, seqs, prefix_len: int, prec: str) -> torch.Tensor:
    """The Secret Sharer's log-perplexity of sequences (M, L) under one
    parameter set: Σ −log softmax(logits)[next word] over the continuation
    positions, the softmax over every padded column → (M,)."""
    M, L = seqs.shape
    one = {k: (v[None] if not isinstance(v, dict)
               else {kk: vv[None] for kk, vv in v.items()})
           for k, v in p.items()}
    hs = _hidden(one, seqs[None], prec, steps=L - 1)[0]     # (M, L-1, H)
    pred = hs[:, prefix_len - 1:]
    logits = _logits(one, pred.reshape(1, -1, pred.shape[-1]), prec)[0]
    targets = seqs[:, prefix_len:].reshape(-1, 1).long()
    lp = logits.gather(-1, targets)[:, 0] - torch.logsumexp(logits, -1)
    return -lp.reshape(M, -1).sum(-1)


def forward_flops_per_token(model: dict) -> float:
    """Operations of one position's forward: the input, recurrent and
    output projections and the tied logits over the published vocabulary
    (two per multiply-add)."""
    d, h, v = model["d_model"], model["d_ff"], model["vocab"]
    return 2.0 * (d * 3 * h + h * 3 * h + h * d + d * v)


def train_flops_per_token(model: dict, seq_len: int = 0) -> float:
    """Forward plus backward at three times the forward (the same at every
    sequence length)."""
    return 3.0 * forward_flops_per_token(model)


def score_flops_per_sequence(model: dict, length: int,
                             prefix_len: int) -> float:
    """What scoring one sequence needs: the recurrence up to the last
    scored position (``length − 1`` steps) and the projection and logits
    at the ``length − prefix_len`` scored positions."""
    d, h, v = model["d_model"], model["d_ff"], model["vocab"]
    steps, scored = length - 1, length - prefix_len
    return 2.0 * (steps * (d * 3 * h + h * 3 * h)
                  + scored * (h * d + d * v))
