"""The paper's production NWP model (§III-A): single-layer CIFG-LSTM with a
tied input-embedding / output-projection, ~1.3M parameters, 10k vocab.

Same structure as the reference ``repro.models.lstm``: the input half of the
gate pre-activations for all timesteps is one hoisted ``(B·S, d) @ (d, 3H)``
product, the recurrence only does ``h @ w_h`` plus the gates per step, and a
projection ``(H → d)`` feeds the tied embedding's logits.

``cfg.cell_path`` selects the recurrent cell:

* ``"fused"`` — the hand-written CUDA cell kernel (`kernels.cifg_cell`),
  once per step; for CPU tensors its wrapper computes the plain cell;
* ``"seq"`` / ``"ref"`` — the plain PyTorch cell (forward only, the two are
  the same here; they differ in the reference's autodiff, which arrives
  with training);
* ``"auto"`` (default) — ``"fused"`` for CUDA tensors, ``"seq"`` on the CPU.

Products run in float32 over compute-dtype operands and are row-stable
(`repro_torch.utils.numerics`); weights are cast once per parameter set
(`repro_torch.utils.params`).
"""
from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cifg_cell import cifg_cell_ref, cifg_states, cifg_step
from repro_torch.models.api import Model
from repro_torch.models.embed import embed_tokens, embedding_init, lm_logits
from repro_torch.models.layers import dense_init
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import round_to, rowstable_mm, torch_dtype
from repro_torch.utils.params import compute_weights, with_compute_copies

CELL_PATHS = ("auto", "fused", "seq", "ref")


def resolve_cell_path(cfg: ModelConfig, device) -> str:
    if cfg.cell_path != "auto":
        return cfg.cell_path
    return "fused" if torch.device(device).type == "cuda" else "seq"


def init(generator: torch.Generator, cfg: ModelConfig, *, device=None):
    """Random parameters drawn from ``generator`` (on the CPU, then moved to
    ``device``), with the compute-dtype copies made."""
    dev = resolve_device(device)
    d, h = cfg.d_model, cfg.d_ff  # embedding dim, hidden size
    params = {
        "embed": embedding_init(generator, cfg, device=dev),
        # split gate matrices with the fan-in of the fused (d+h, 3h) matrix
        "w_x": dense_init(generator, (d, 3 * h), in_dim=d + h, device=dev),
        "w_h": dense_init(generator, (h, 3 * h), in_dim=d + h, device=dev),
        "b_gates": torch.zeros((3 * h,), dtype=torch.float32, device=dev),
        "w_proj": dense_init(generator, (h, d), in_dim=h, device=dev),
    }
    return with_compute_copies(params, cfg.compute_dtype)


def _on(cw, tokens) -> torch.Tensor:
    """Token ids (array or tensor) → int64 on the parameters' device."""
    return torch.as_tensor(tokens, device=cw["w_h"].device).long()


def _input_projection(params, cw, x, cd):
    """Hoisted input half of the gate pre-activations for all timesteps:
    x (B, S, d) → zx (B, S, 3H) float32 (the product rounded to the compute
    dtype, then the bias added, as in the reference)."""
    B, S, d = x.shape
    zx = round_to(rowstable_mm(x.reshape(B * S, d), cw["w_x"]), cd)
    return zx.reshape(B, S, -1) + params["b_gates"]


def _states(cw, zx, cfg: ModelConfig, cd):
    """zx (B, S, 3H) → the full state stacks (hs, cs), each (S, B, H)."""
    B = zx.shape[0]
    h0 = torch.zeros((B, cfg.d_ff), dtype=torch.float32, device=zx.device)
    path = resolve_cell_path(cfg, zx.device)
    return cifg_states(zx.transpose(0, 1), h0, torch.zeros_like(h0),
                       cw["w_h"], cell="fused" if path == "fused" else "seq",
                       compute_dtype=cd)


def _logits(cw, h, cd):
    """Hidden states (N, H) → logits (N, Vpad) float32."""
    y = round_to(rowstable_mm(round_to(h, cd), cw["w_proj"]), cd)
    return lm_logits(cw, y[:, None, :])[:, 0, :]


def forward(params, batch, cfg: ModelConfig, *, collect_cache: bool = False):
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_weights(params, cd)
    tokens = _on(cw, batch["tokens"])
    B, S = tokens.shape
    x = embed_tokens(cw, tokens, cd)                 # (B, S, d)
    zx = _input_projection(params, cw, x, cd)        # (B, S, 3H)
    hs, cs = _states(cw, zx, cfg, cd)                # (S, B, H)
    logits = _logits(cw, hs.transpose(0, 1).reshape(B * S, -1), cd)
    logits = logits.reshape(B, S, -1)
    if collect_cache:
        return logits, (hs[-1], cs[-1])
    return logits


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int, *,
               device=None):
    """Decode cache. Every leaf is per-row (leading dim = batch), as the
    serving engine scatters sessions by slot."""
    del max_len  # recurrent state — nothing grows with the length
    dev = resolve_device(device)
    h = cfg.d_ff
    return {"h": torch.zeros((batch_size, h), dtype=torch.float32, device=dev),
            "c": torch.zeros((batch_size, h), dtype=torch.float32, device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev)}


def prefill(params, batch, cfg: ModelConfig, *, max_len: int = None):
    """Prompt prefill → (last-position logits (B, Vpad), decode cache).

    An optional ``batch["length"]`` ((B,) ints, 1 ≤ length ≤ S) marks each
    row's true prompt length inside right-padded ``tokens``. The recurrence
    is causal and the products are row-stable, so the state and logits
    gathered at ``length - 1`` are bitwise those of an unpadded prefill of
    exactly ``length`` tokens."""
    del max_len
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_weights(params, cd)
    tokens = _on(cw, batch["tokens"])
    B, S = tokens.shape
    if "length" in batch:
        length = torch.as_tensor(batch["length"]).long()
        if length.shape != (B,):
            raise ValueError(f"length must be (B,)=({B},), got "
                             f"{tuple(length.shape)}")
        if length.device.type == "cpu" and (
                int(length.min()) < 1 or int(length.max()) > S):
            raise ValueError(f"length must lie in [1, {S}], got "
                             f"{length.tolist()}")
        length = length.to(tokens.device)
    else:
        length = torch.full((B,), S, dtype=torch.long, device=tokens.device)
    x = embed_tokens(cw, tokens, cd)
    zx = _input_projection(params, cw, x, cd)
    hs, cs = _states(cw, zx, cfg, cd)
    rows = torch.arange(B, device=tokens.device)
    h = hs[length - 1, rows]
    c = cs[length - 1, rows]
    return _logits(cw, h, cd), {"h": h, "c": c,
                                "pos": length.to(torch.int32)}


def decode_step(params, tokens, cache, cfg: ModelConfig):
    cd = torch_dtype(cfg.compute_dtype)
    cw = compute_weights(params, cd)
    x = embed_tokens(cw, _on(cw, tokens), cd)        # (B, d)
    zx = round_to(rowstable_mm(x, cw["w_x"]), cd) + params["b_gates"]
    if resolve_cell_path(cfg, zx.device) == "fused":
        h, c = cifg_step(zx, cache["h"], cache["c"], cw["w_h"],
                         compute_dtype=cd)
    else:
        h, c = cifg_cell_ref(zx, cache["h"], cache["c"], cw["w_h"],
                             compute_dtype=cd)
    return _logits(cw, h, cd), {"h": h, "c": c, "pos": cache["pos"] + 1}


def build(cfg: ModelConfig) -> Model:
    if cfg.cell_path not in CELL_PATHS:
        raise ValueError(f"cell_path must be one of {CELL_PATHS}, "
                         f"got {cfg.cell_path!r}")
    return Model(
        cfg=cfg,
        init=partial(init, cfg=cfg),
        forward=partial(forward, cfg=cfg),
        init_cache=partial(init_cache, cfg),
        prefill=partial(prefill, cfg=cfg),
        decode_step=partial(decode_step, cfg=cfg),
    )
