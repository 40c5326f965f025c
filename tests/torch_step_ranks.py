"""What one rank runs in the production-step tests
(`test_torch_prod_sharded.py`). Imports nothing of JAX or of the JAX
package: the spawned ranks import this module (and `repro_torch`) only.

A case is a picklable dict (:func:`case`): a reduced config, the starting
params (numpy, the reference's tree when the test carries them across),
the batch and the noise. :func:`run_cases` builds the mesh once, runs every
case's train step and its serving steps on it, and returns what the tests
compare: the new params and momentum (whole, numpy), the metrics, and the
logits of a prefill and of the decode steps after it. Called in the test
process inside `mesh.one_rank` it is the (1, 1) run.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs import DPConfig, InputShape, MeshConfig, get_config
from repro_torch.core.server_optim import init_state
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build
from repro_torch.sharding import specs as SP
from repro_torch.utils.params import strip_compute, with_compute_copies
from repro_torch.utils.pytree import tree_map

C, S = 4, 16          # clients of the train step, tokens per client
CLIP = 0.8            # the clip norm S
NOISE_SEED = 7        # the seed of the step's noise generator
SERVE_B, DECODE = 4, 4  # prefill rows, decode steps after it


def case(name: str, arch: str, params: Dict, tokens: np.ndarray, *,
         z: float = 0.0, kv: int = None, serve: bool = True) -> Dict:
    """One configuration: ``arch`` reduced (``kv`` KV heads if given),
    starting ``params`` (numpy tree), ``tokens`` (C, S + DECODE + 1)."""
    return dict(name=name, arch=arch, params=params, tokens=tokens, z=z,
                kv=kv, serve=serve)


def config(arch: str, kv: int = None):
    cfg = get_config(arch).reduced()
    return cfg.with_(n_kv_heads=kv) if kv else cfg


def init_params(arch: str, kv: int = None, seed: int = 0) -> Dict:
    """Starting params from a seed (the port's init), as numpy."""
    model = build(config(arch, kv))
    p = strip_compute(model.init(torch.Generator().manual_seed(seed),
                                 device="cpu"))
    return tree_map(lambda t: t.numpy(), p)


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def run_case(dev: torch.device, mesh, mcfg: MeshConfig, c: Dict) -> Dict:
    cfg = config(c["arch"], c["kv"])
    model = build(cfg)
    p0 = tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev),
                  c["params"])
    pspecs = SP.param_specs(ST.params_shape(model), cfg, mcfg)
    toks = torch.from_numpy(c["tokens"]).long().to(dev)
    dp = DPConfig(clients_per_round=C, noise_multiplier=c["z"],
                  clip_norm=CLIP)
    step = ST.make_fed_train_step(model, dp, mesh, mcfg, pspecs,
                                  InputShape("tiny_train", S, C, "train"))
    st = init_state(p0)
    st = st._replace(momentum=SP.distribute_params(st.momentum, pspecs,
                                                   mesh))
    batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
    gen = torch.Generator(dev).manual_seed(NOISE_SEED)
    params, st, metrics = step(SP.distribute_params(p0, pspecs, mesh), st,
                               batch, gen)
    out = {"params": _numpy(SP.gather_params(params)),
           "momentum": _numpy(SP.gather_params(st.momentum)),
           "count": int(st.count),
           "metrics": {k: float(v) for k, v in metrics.items()}}
    if c["serve"]:
        out["logits"] = serve(dev, mesh, mcfg, model, pspecs, p0, toks)
    return out


def serve(dev, mesh, mcfg, model, pspecs, p0, toks) -> List[np.ndarray]:
    """The prefill step over the first S tokens, then DECODE decode steps
    against a cache of S + DECODE slots: every step's logits, whole."""
    L = S + DECODE
    pre = ST.make_prefill_step(model, mesh, mcfg, pspecs,
                               InputShape("tiny_prefill", S, SERVE_B,
                                          "prefill"), max_len=L)
    dec = ST.make_decode_step(model, mesh, mcfg, pspecs,
                              InputShape("tiny_decode", L, SERVE_B,
                                         "decode"))
    params = SP.distribute_params(p0, pspecs, mesh)
    logits, cache = pre(params, {"tokens": toks[:SERVE_B, :S]})
    outs = [logits.full_tensor()]
    for i in range(DECODE):
        logits, cache = dec(params, toks[:SERVE_B, S + i], cache)
        outs.append(logits.full_tensor())
    return [o.float().cpu().numpy() for o in outs]


def serve_unsharded(arch: str, params: Dict, tokens: np.ndarray, kv=None
                    ) -> List[np.ndarray]:
    """The same through the model's own ``prefill`` / ``decode_step``."""
    model = build(config(arch, kv))
    p = with_compute_copies(tree_map(torch.from_numpy, params),
                            model.cfg.compute_dtype, model.compute_copies)
    toks = torch.from_numpy(tokens).long()
    logits, cache = model.prefill(p, {"tokens": toks[:SERVE_B, :S]},
                                  max_len=S + DECODE)
    outs = [logits]
    for i in range(DECODE):
        logits, cache = model.decode_step(p, toks[:SERVE_B, S + i], cache)
        outs.append(logits)
    return [o.float().numpy() for o in outs]


def run_cases(dev: torch.device, shape, axes, cases: List[Dict]) -> Dict:
    """Every case on one mesh of ``shape`` over ``axes``."""
    mcfg = MeshConfig(tuple(shape), tuple(axes))
    mesh = make_production_mesh(multi_pod="pod" in axes, shape=shape,
                                device_type=dev.type)
    return {c["name"]: run_case(dev, mesh, mcfg, c) for c in cases}


def run_topologies(dev: torch.device, plan: Dict) -> Dict:
    """``plan``: {name: (shape, axes, cases)}, meshes over the same ranks,
    run one after the other on one intra-op thread a rank (the ranks share
    the cores) → {name: `run_cases`' result}."""
    torch.set_num_threads(1)
    return {name: run_cases(dev, shape, axes, cases)
            for name, (shape, axes, cases) in plan.items()}
