"""The paper's technique is architecture-agnostic: one DP-FedAvg round on a
reduced variant of every assigned architecture — dense, MoE, SSM, hybrid,
VLM, audio — through the same Algorithm-1 machinery. The port's
counterpart of the reference's ``examples/multi_arch_training.py``.

    PYTHONPATH=src python -m repro_torch.examples.multi_arch_training
    PYTHONPATH=src python -m repro_torch.examples.multi_arch_training --device cpu

Runs on the card by default (the forward through the flash and SSD scan
kernels, their gradients through the plain versions) and raises without
one unless ``--device cpu`` is given. Weights and batches are drawn from
seeds; the frame and image-patch embeddings of the whisper and chameleon
stubs are zeros, as in the reference.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import (ASSIGNED_ARCHS, ClientConfig, DPConfig,
                                 get_config)
from repro_torch.core.dp_fedavg import finalize_round, server_step
from repro_torch.core.server_optim import init_state
from repro_torch.fl.client import user_update
from repro_torch.models import build
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import strip_compute
from repro_torch.utils.pytree import tree_leaves, tree_map

DP = DPConfig(clients_per_round=4, noise_multiplier=0.3, clip_norm=0.5)
CLIENT = ClientConfig(local_epochs=1, batch_size=2, lr=0.1)
B, S = 2, 16


def client_batches(cfg, user: int, dev) -> dict:
    """One batch of B × S tokens (leading n_batches axis of 1), with the
    family's stub inputs, drawn for ``user``."""
    gen = torch.Generator().manual_seed(user)
    toks = torch.randint(0, cfg.vocab, (1, B, S + 1), generator=gen)
    b = {"tokens": toks[:, :, :-1], "labels": toks[:, :, 1:]}
    if cfg.family == "encdec":
        b["frames"] = torch.zeros((1, B, cfg.n_audio_frames, cfg.d_model))
    if cfg.family == "vlm":
        b["image_embeds"] = torch.zeros((1, B, cfg.n_image_tokens,
                                         cfg.d_model))
    return {k: v.to(dev) for k, v in b.items()}


def one_round(arch: str, dev, n_clients: int = 4):
    """One DP-FedAvg round of ``arch`` reduced → (cfg, mean loss, ‖noised
    Δ̄‖, clipped fraction, σ)."""
    cfg = get_config(arch).reduced()
    model = build(cfg)
    params = strip_compute(model.init(torch.Generator().manual_seed(0),
                                      device=dev))
    opt_state = init_state(params)
    total, clipped, losses = None, [], []
    for u in range(n_clients):
        delta, _, was_clipped, loss = user_update(
            model, params, client_batches(cfg, u, dev), CLIENT, DP)
        total = delta if total is None else tree_map(torch.add, total, delta)
        clipped.append(float(was_clipped))
        losses.append(float(loss))
    noised, stats = finalize_round(total, n_clients,
                                   torch.Generator(device=dev).manual_seed(99),
                                   DP)
    server_step(params, opt_state, noised, DP)
    dn = float(torch.sqrt(sum(torch.sum(torch.square(l))
                              for l in tree_leaves(noised))))
    return cfg, float(np.mean(losses)), dn, float(np.mean(clipped)), \
        float(stats.noise_std)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"{'arch':24s} {'family':8s} {'loss':>8s} {'|delta|':>9s} "
          f"{'clipped':>8s} {'|noise_std|':>11s}")
    for arch in ASSIGNED_ARCHS:
        cfg, loss, dn, clipped, sigma = one_round(arch, dev)
        print(f"{arch:24s} {cfg.family:8s} {loss:8.3f} {dn:9.4f} "
              f"{clipped:8.2f} {sigma:11.2e}")
    print("\nevery family above went through clip -> average -> noise -> "
          "momentum unchanged (DESIGN.md §Arch-applicability).")


if __name__ == "__main__":
    main()
