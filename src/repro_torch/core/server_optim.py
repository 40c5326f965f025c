"""Server optimizers for DP-FedAvg (paper Table 1 / Table 6 ablation).

The paper's production configuration is Nesterov momentum with η_s=1.0,
μ=0.99; plain SGD and Adam are the Table 6 ablation. State and updates are
float32 trees; the "gradient" is the negated averaged model delta (the
server moves along +Δ), so Δ is fed directly and added.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import DPConfig
from repro_torch.utils.pytree import tree_map


class ServerOptState(NamedTuple):
    momentum: object   # tree of f32 zeros at init
    nu: object         # adam second moment
    count: object      # server steps taken: an int, or a device scalar
                       # once the engine's fault model selects it


def init_state(params) -> ServerOptState:
    def zeros(t):
        return tree_map(lambda l: torch.zeros_like(l, dtype=torch.float32), t)
    return ServerOptState(momentum=zeros(params), nu=zeros(params), count=0)


def apply_update(params, delta, state: ServerOptState, dp: DPConfig):
    """θ ← θ + ServerOpt(Δ). Returns (new_params, new_state)."""
    lr = dp.server_lr
    if dp.server_opt == "sgd":
        new_params = tree_map(lambda p, d: (p.float() + lr * d).to(p.dtype),
                              params, delta)
        return new_params, state._replace(count=state.count + 1)

    if dp.server_opt == "momentum":
        mu = dp.server_momentum
        new_m = tree_map(lambda m, d: mu * m + d.float(), state.momentum,
                         delta)
        if dp.nesterov:
            step = tree_map(lambda m, d: mu * m + d.float(), new_m, delta)
        else:
            step = new_m
        new_params = tree_map(lambda p, s: (p.float() + lr * s).to(p.dtype),
                              params, step)
        return new_params, state._replace(momentum=new_m,
                                          count=state.count + 1)

    if dp.server_opt == "adam":
        b1, b2, eps = 0.9, 0.999, dp.adam_eps
        cnt = state.count + 1
        new_m = tree_map(lambda m, d: b1 * m + (1 - b1) * d.float(),
                         state.momentum, delta)
        new_v = tree_map(lambda v, d: b2 * v + (1 - b2) * torch.square(
            d.float()), state.nu, delta)
        # bias corrections in float32, as the reference computes them; a
        # device count (the engine's fault model) stays on the device
        if isinstance(cnt, torch.Tensor):
            c = cnt.to(torch.float32)
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32,
                                     device=c.device) ** c
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32,
                                     device=c.device) ** c
        else:
            c = torch.tensor(float(cnt), dtype=torch.float32)
            bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** c)
            bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** c)
        new_params = tree_map(
            lambda p, m, v: (p.float() + lr * (m / bc1)
                             / (torch.sqrt(v / bc2) + eps)).to(p.dtype),
            params, new_m, new_v)
        return new_params, ServerOptState(new_m, new_v, cnt)

    raise ValueError(f"unknown server_opt {dp.server_opt!r}")
