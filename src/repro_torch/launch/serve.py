"""Serving CLI of the port: a thin frontend over the continuous-batching
engine (`repro_torch.serve.ServeEngine`) — session admission, batched decode
with the session cache on the device, top-k candidates, and an optional
checkpoint hot-swap drill. Runs on the GPU unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --batch 8 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --ckpt experiments/runs/gboard-cifg-lstm_r100.msgpack --steps 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
        --reference --prompt-len 512 --steps 16

``--reference`` runs the one-shot batch path (:func:`generate`) instead of
the engine; it is the path of ``mamba2-370m`` and ``zamba2-2.7b``, whose
caches the engine refuses (their leaves are layer-leading with a shared
position). ``--ckpt`` and ``--hot-swap`` read checkpoints of the JAX
package's msgpack format (which needs ``msgpack``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build
from repro_torch.serve import NwpRequest, ServeEngine
from repro_torch.serve.frontend import make_session_key
from repro_torch.serve.sampling import fold_in, sample_tokens
from repro_torch.train import checkpoint
from repro_torch.utils.device import resolve_device
from repro_torch.utils.params import from_jax_params, param_device

BOS = 2  # the tokenizer's begin-of-sentence id (PAD, UNK, BOS, EOS = 0..3)


def generate(model, params, prompts: torch.Tensor, steps: int,
             temperature=0.0, seed=None):
    """prompts: (B, S0) int → (B, S0+steps). Greedy where temperature=0.

    ``temperature`` is one float for every row or a sequence of B, one per
    row. ``steps=0`` returns exactly the prompts. Temperature sampling
    needs ``seed``; each batch row samples from its own stream (row ``i``'s
    key is ``fold_in(key(seed), i)``). The prefill gets ``max_len = S0 +
    steps`` (the reference's default), so a model with a KV cache has a
    slot for every decoded token."""
    if steps < 0:
        raise ValueError(f"steps must be >= 0, got {steps}")
    dev = param_device(params)
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, S0 = prompts.shape
    temps_np = np.broadcast_to(np.asarray(temperature, np.float32), (B,))
    if (temps_np > 0.0).any() and seed is None:
        raise ValueError("generate(temperature>0) needs a seed so sampling "
                         "is reproducible (greedy decoding needs none)")
    if steps == 0:
        return prompts
    last, cache = model.prefill(params, {"tokens": prompts},
                                max_len=S0 + steps)
    vocab = model.cfg.vocab
    base = make_session_key(seed)
    keys = torch.tensor(np.stack([fold_in(base, i) for i in range(B)])
                        .astype(np.int64), device=dev)
    temps = torch.from_numpy(temps_np.copy()).to(dev)

    def pick(logits, t):
        return sample_tokens(logits[:, :vocab], keys,
                             torch.full((B,), t, dtype=torch.int64,
                                        device=dev), temps)

    toks = [pick(last, 0)]
    for t in range(1, steps):
        logits, cache = model.decode_step(params, toks[-1], cache)
        toks.append(pick(logits, t))
    return torch.cat([prompts, torch.stack(toks, dim=1).long()], dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gboard-cifg-lstm")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of sessions to submit")
    ap.add_argument("--slots", type=int, default=None,
                    help="engine decode slots (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (session i uses seed+i)")
    ap.add_argument("--top-k", type=int, default=3,
                    help="suggestion-strip candidates per position")
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--hot-swap", default=None, metavar="CKPT",
                    help="promote this checkpoint mid-run (hot-swap demo)")
    ap.add_argument("--reference", action="store_true",
                    help="run the one-shot batch reference path instead "
                         "of the continuous-batching engine")
    ap.add_argument("--cell-path", default=None,
                    choices=["auto", "fused", "seq", "ref"],
                    help="lstm recurrent cell: fused = the CUDA cell kernel, "
                         "seq/ref = plain PyTorch, auto = fused on the GPU")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family == "lstm":
        cfg = cfg.with_(vocab=args.vocab)
    if args.cell_path is not None:
        cfg = cfg.with_(cell_path=args.cell_path)
    model = build(cfg)
    if args.ckpt:
        tree, meta = checkpoint.load(args.ckpt)
        params = from_jax_params(tree, model.compute_copies, device=dev,
                                 compute_dtype=cfg.compute_dtype)
        print(f"loaded checkpoint ({meta})")
    else:
        # the CIFG-LSTM draws on the CPU (its weights for a seed stay those
        # of every earlier run); the larger families draw on the device
        gen = torch.Generator(device="cpu" if cfg.family == "lstm" else dev)
        params = model.init(gen.manual_seed(0), device=dev)
        print("serving a randomly initialized model (pass --ckpt)")

    rng = np.random.default_rng(args.seed + 1)
    prompts = np.full((args.batch, args.prompt_len), BOS, np.int64)
    prompts[:, 1:] = rng.integers(4, cfg.vocab,
                                  (args.batch, args.prompt_len - 1))

    if args.reference:
        out = generate(model, params, prompts, args.steps, args.temperature,
                       args.seed if args.temperature > 0 else None)
        for row in out.cpu().numpy():
            print("prompt:", row[:args.prompt_len].tolist(),
                  "→ continuation:", row[args.prompt_len:].tolist())
        return

    engine = ServeEngine(model, params, max_slots=args.slots or args.batch,
                         top_k=args.top_k)
    sids = [engine.submit(NwpRequest(
        prompt=tuple(int(t) for t in prompts[i]), steps=args.steps,
        temperature=args.temperature,
        seed=args.seed + i if args.temperature > 0 else None))
        for i in range(args.batch)]
    if args.hot_swap:
        for _ in range(max(1, args.steps // 2)):
            engine.step()
        v = engine.load_checkpoint(args.hot_swap)
        print(f"hot-swapped to {args.hot_swap} (params v{v}, "
              f"{engine.active_sessions} sessions in flight)")
    engine.run()
    for sid in sids:
        r = engine.result(sid)
        print(f"{sid} [{r.status}] prompt: {list(r.prompt)} → "
              f"continuation: {list(r.tokens)} "
              f"(strip: {r.candidates[-1].tolist() if len(r.tokens) else []})")


if __name__ == "__main__":
    main()
