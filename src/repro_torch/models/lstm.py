"""The paper's production NWP model (§III-A): single-layer CIFG-LSTM with a
tied input-embedding / output-projection, ~1.3M parameters, 10k vocab.

Same structure as the reference ``repro.models.lstm``: the input half of the
gate pre-activations for all timesteps is one hoisted ``(B·S, d) @ (d, 3H)``
product, the recurrence only does ``h @ w_h`` plus the gates per step, and a
projection ``(H → d)`` feeds the tied embedding's logits.

``cfg.cell_path`` selects the recurrent cell:

* ``"fused"`` — `kernels.cifg_cell.cifg_sequence` with the hand-written CUDA
  cell kernel as the per-step forward and the time-fused backward (gate
  recompute and ``dw_h`` batched over time outside the reverse loop); a
  single step (``decode_step``) runs the forward kernel with the CUDA
  backward kernel as its gradient. For CPU tensors the kernel wrappers
  compute the plain cell;
* ``"seq"`` — the same sequence op stepping the plain PyTorch cell;
* ``"ref"`` — plain autograd through a loop over the plain cell, the
  reference's validated path;
* ``"auto"`` (default) — ``"fused"`` for CUDA tensors, ``"seq"`` on the CPU.

Products run in float32 over compute-dtype operands and are row-stable
(`repro_torch.utils.numerics`). Weights: a parameter set that carries its
compute copies (``params["compute"]``, made once for serving by
`repro_torch.utils.params`) computes with them; one without them — every
training parameter set — casts ``tok``, ``w_x``, ``w_h`` and ``w_proj`` to
the compute dtype inside the autograd graph on every call (`_weights`).
``loss_fn`` always takes the second road.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.cifg_cell import (cifg_cell_ref, cifg_sequence,
                                           cifg_states, cifg_step)
from repro_torch.models.api import Model
from repro_torch.models.embed import embed_tokens, embedding_init, lm_logits
from repro_torch.models.layers import dense_init, lm_loss
from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import round_to, rowstable_mm, torch_dtype
from repro_torch.utils.params import (COMPUTE, strip_compute,
                                      with_compute_copies)

CELL_PATHS = ("auto", "fused", "seq", "ref")


def resolve_cell_path(cfg: ModelConfig, device) -> str:
    if cfg.cell_path != "auto":
        return cfg.cell_path
    return "fused" if torch.device(device).type == "cuda" else "seq"


def compute_copies(params, cd: torch.dtype):
    """The weights the serving path computes with: ``w_h`` in the compute
    dtype, the operand of the cell kernel; ``tok`` (and ``head``), ``w_x``
    and ``w_proj`` rounded to the compute dtype and held in float32, the
    operands of the float32 products (`repro_torch.utils.numerics`)."""
    copies = {"tok": round_to(params["embed"]["tok"], cd),
              "w_x": round_to(params["w_x"], cd),
              "w_h": params["w_h"].to(cd).contiguous(),
              "w_proj": round_to(params["w_proj"], cd)}
    if "head" in params["embed"]:
        copies["head"] = round_to(params["embed"]["head"], cd)
    return copies


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
    return with_compute_copies(params, cfg.compute_dtype, compute_copies)


def _weights(params, cd):
    """The weights the products use: the cached compute copies when
    ``params`` carries them (serving), else casts made inside the autograd
    graph (training): ``tok`` stays float32 for the gather (the row is cast
    after it, as the reference casts), the head, ``w_x`` and ``w_proj`` are
    rounded to the compute dtype, and ``w_h`` goes to the recurrence as it
    is, which casts it itself and returns its gradient in float32."""
    if COMPUTE in params:
        return params[COMPUTE]
    emb = params["embed"]
    return {"tok": emb["tok"],
            "head": round_to(emb.get("head", emb["tok"]), cd),
            "w_x": round_to(params["w_x"], cd),
            "w_h": params["w_h"],
            "w_proj": round_to(params["w_proj"], cd)}


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


def _recurrence(cw, zx, cfg: ModelConfig, cd, remat: bool):
    """zx (B, S, 3H) → (hs (S, B, H), (h_fin, c_fin)), differentiable, on
    the resolved ``cell_path``."""
    B, S = zx.shape[:2]
    h = torch.zeros((B, cfg.d_ff), dtype=torch.float32, device=zx.device)
    c = torch.zeros_like(h)
    path = resolve_cell_path(cfg, zx.device)
    zx = zx.transpose(0, 1)
    if path in ("fused", "seq"):
        return cifg_sequence(zx, h, c, cw["w_h"], cell=path,
                             compute_dtype=cd, remat=remat)

    def step(zx_t, h, c):
        return cifg_cell_ref(zx_t, h, c, cw["w_h"], compute_dtype=cd)

    hs = []
    for t in range(S):
        if remat and torch.is_grad_enabled():
            h, c = checkpoint(step, zx[t], h, c, use_reentrant=False)
        else:
            h, c = step(zx[t], h, c)
        hs.append(h)
    return torch.stack(hs), (h, c)


def _logits(cw, h, cd):
    """Hidden states (N, H) → logits (N, Vpad) float32."""
    y = round_to(rowstable_mm(round_to(h, cd), cw["w_proj"]), cd)
    return lm_logits(cw, y[:, None, :])[:, 0, :]


def forward(params, batch, cfg: ModelConfig, *, remat: bool = False,
            collect_cache: bool = False):
    cd = torch_dtype(cfg.compute_dtype)
    cw = _weights(params, cd)
    tokens = _on(cw, batch["tokens"])
    B, S = tokens.shape
    x = embed_tokens(cw, tokens, cd)                 # (B, S, d)
    zx = _input_projection(params, cw, x, cd)        # (B, S, 3H)
    hs, fin = _recurrence(cw, zx, cfg, cd, remat)    # (S, B, H)
    logits = _logits(cw, hs.transpose(0, 1).reshape(B * S, -1), cd)
    logits = logits.reshape(B, S, -1)
    if collect_cache:
        return logits, fin
    return logits


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = False):
    """Masked next-word cross-entropy (float32 scalar). The weights are cast
    inside the graph: any compute copies ``params`` carries are ignored."""
    logits = forward(strip_compute(params), batch, cfg, remat=remat)
    return lm_loss(logits, batch["labels"], cfg.vocab, batch.get("mask"))


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
    cw = _weights(params, cd)
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
    cw = _weights(params, cd)
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
        loss_fn=partial(loss_fn, cfg=cfg),
        init_cache=partial(init_cache, cfg),
        prefill=partial(prefill, cfg=cfg),
        decode_step=partial(decode_step, cfg=cfg),
        compute_copies=compute_copies,
    )
