"""Multi-pod dry run: build every (arch × input shape × mesh) step of
`repro_torch.launch.steps` at the production meshes' 256 and 512 ranks,
without a device (the port of the reference's ``launch/dryrun.py``).

The reference lowers and compiles each step for placeholder devices. The
port traces it instead: one process joins a ``torch.distributed`` group of
backend ``"fake"`` (``FakeStore``) as rank 0 of 256 (16 × 16) or 512
(2 × 16 × 16) ranks, lays the DTensor mesh over it, and runs the step under
``FakeTensorMode``, so no tensor holds memory and no collective moves a
byte. Each record holds

* ``n_params``, and ``arg_bytes``: the bytes one rank holds of the step's
  arguments (params, optimizer state and batch for the train step; params
  and batch for the prefill; params, tokens and cache for the decode step),
  each leaf's local shard from its spec's placements;
* ``flops``: what ``torch.utils.flop_counter.FlopCounterMode`` counts on
  rank 0: DTensor operations at their global shapes over the model axis
  (the work of rank 0's batch row, its model ranks together; divide by
  the model axis for one rank), the kernels' plain versions inside
  ``local_map`` at their local shapes; matrix products and attention
  only, no elementwise work;
* ``collectives``: the count and result bytes of each collective kind rank
  0 issues, from ``torch.distributed.tensor.debug.CommDebugMode``.

The train step's microbatches run the same body C / rows times: the dry
run traces the first and scales its FLOPs and collectives by the count
(``micro_scale`` in the record). The reference's ``memory_analysis`` (its
temporaries' bytes) has no counterpart here: nothing is compiled, and
FakeTensorMode keeps no allocator that could report a peak.

Records go to ``experiments/dryrun_torch/`` (never the reference's
``experiments/dryrun/``).

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import (ASSIGNED_ARCHS, INPUT_SHAPES, DPConfig,
                                 InputShape, ModelConfig, get_config)
from repro_torch.core.server_optim import ServerOptState
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.models import build
from repro_torch.sharding import specs as SP
from repro_torch.utils.pytree import tree_leaves, tree_map

RESULTS_DIR = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")

FULL_ATTN_FAMILIES = ("dense", "moe", "vlm", "encdec")
LONG_WINDOW = 4096

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


def arch_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k needs sub-quadratic attention: the full-attention families
    switch to the sliding-window variant (window 4096). The SSM runs
    natively; the hybrid's shared-attention KV stays exact."""
    if shape.name == "long_500k" and cfg.family in FULL_ATTN_FAMILIES:
        return cfg.with_(attn_window=LONG_WINDOW)
    return cfg


def count_params(params_sh) -> int:
    return sum(l.numel() for l in tree_leaves(params_sh))


def local_shape(shape, spec, sizes) -> tuple:
    """The shape of one rank's shard of a leaf of ``shape`` under
    ``spec``, over a mesh of axis ``sizes``."""
    out = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        axes = e if isinstance(e, tuple) else (() if e is None else (e,))
        out.append(n // math.prod(sizes[a] for a in axes))
    return tuple(out)


def shard_bytes(tree, specs, sizes) -> int:
    """The bytes one rank holds of ``tree`` laid out in ``specs``."""
    total = 0

    def one(names, leaf):
        nonlocal total
        spec = specs
        for k in names:
            spec = spec[k]
        n = math.prod(local_shape(tuple(leaf.shape), spec, sizes))
        total += n * leaf.element_size()

    SP.spec_tree_map(one, tree)
    return total


class _Comms:
    """``CommDebugMode`` with each collective's result bytes beside its
    count, by kind."""

    def __init__(self):
        from torch.distributed.tensor.debug import CommDebugMode

        stats = {c: {"count": 0, "bytes": 0} for c in COLLECTIVES}

        class Mode(CommDebugMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                before = self.get_total_counts()
                out = super().__torch_dispatch__(func, types, args, kwargs)
                if out is not NotImplemented and \
                        self.get_total_counts() > before:
                    name = func._overloadpacket.__name__
                    kind = next((c for c in COLLECTIVES if c in name), name)
                    rec = stats.setdefault(kind, {"count": 0, "bytes": 0})
                    rec["count"] += 1
                    rec["bytes"] += sum(t.numel() * t.element_size()
                                        for t in _tensors(out))
                return out

        self.mode = Mode()
        self.stats = stats

    def record(self, scale: int = 1) -> dict:
        out = {k: {"count": v["count"] * scale, "bytes": v["bytes"] * scale}
               for k, v in self.stats.items()}
        out["total_bytes"] = sum(v["bytes"] for v in out.values())
        return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


@contextlib.contextmanager
def fake_world(n: int):
    """This process as rank 0 of a fake group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dtensors(tree_sh, specs, mesh):
    """Fake DTensors of a tree of meta stand-ins, laid out in ``specs``."""
    from torch.distributed.tensor import DTensor
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))

    def one(names, leaf):
        spec = specs
        for k in names:
            spec = spec[k]
        local = torch.zeros(local_shape(tuple(leaf.shape), spec, sizes),
                            dtype=leaf.dtype)
        return DTensor.from_local(local, mesh, SP.placements(spec, mesh),
                                  run_check=False, shape=tuple(leaf.shape),
                                  stride=torch.empty(tuple(leaf.shape),
                                                     device="meta").stride())

    return SP.spec_tree_map(one, tree_sh)


def _plain(tree_sh):
    return tree_map(lambda l: torch.zeros(tuple(l.shape), dtype=l.dtype),
                    tree_sh)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool,
               save: bool = True, verbose: bool = True,
               cfg: ModelConfig = None, mesh_shape=None) -> dict:
    """Trace one step on a fake world and return (and save) its record.
    ``cfg`` and ``mesh_shape`` override the config and the mesh's counts
    (for a small run)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(cfg or get_config(arch), shape)
    base = mesh_config(multi_pod=multi_pod)
    mcfg = base if mesh_shape is None else type(base)(tuple(mesh_shape),
                                                     base.axes)
    sizes = dict(zip(mcfg.axes, mcfg.shape))
    model = build(cfg)
    t0 = time.time()
    params_sh = ST.params_shape(model)
    pspecs = SP.param_specs(params_sh, cfg, mcfg)
    inputs = ST.input_specs(cfg, shape)
    bspecs = SP.batch_specs(cfg, shape, mcfg)
    name = "x".join(map(str, mcfg.shape))
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "n_devices": mcfg.n_devices, "n_params": count_params(params_sh)}
    comms = _Comms()
    scale = 1
    with fake_world(mcfg.n_devices):
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mcfg.shape,
                                    device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True):
            params = _dtensors(params_sh, pspecs, mesh)
            flops = FlopCounterMode(display=False)
            if shape.kind == "train":
                opt_sh = ST.opt_state_shape(params_sh)
                opt = ServerOptState(
                    momentum=_dtensors(opt_sh.momentum, pspecs, mesh),
                    nu=_dtensors(opt_sh.nu, pspecs, mesh),
                    count=torch.zeros((), dtype=torch.int32))
                rec["arg_bytes"] = (
                    shard_bytes(params_sh, pspecs, sizes)
                    + 2 * shard_bytes(opt_sh.momentum, pspecs, sizes)
                    + opt_sh.count.element_size()
                    + shard_bytes(inputs, bspecs, sizes))
                step = ST.make_fed_train_step(
                    model, DPConfig(clients_per_round=shape.global_batch),
                    mesh, mcfg, pspecs, shape)
                scale = shape.global_batch // SP.batch_axis_size(mcfg)
                with flops, comms.mode:
                    step(params, opt, _plain(inputs), torch.Generator(),
                         n_micro=1)
            elif shape.kind == "prefill":
                rec["arg_bytes"] = (shard_bytes(params_sh, pspecs, sizes)
                                    + shard_bytes(inputs, bspecs, sizes))
                step = ST.make_prefill_step(model, mesh, mcfg, pspecs, shape)
                with flops, comms.mode:
                    step(params, _plain(inputs))
            else:
                cache_sh = ST.cache_shape(model, shape)
                cspecs = SP.cache_specs(cache_sh, cfg, shape, mcfg)
                tok_spec = {"tokens": SP.Spec(bspecs["tokens"][0])}
                rec["arg_bytes"] = (shard_bytes(params_sh, pspecs, sizes)
                                    + shard_bytes(inputs, tok_spec, sizes)
                                    + shard_bytes(cache_sh, cspecs, sizes))
                step = ST.make_decode_step(model, mesh, mcfg, pspecs, shape)
                with flops, comms.mode:
                    step(params, _plain(inputs)["tokens"],
                         _dtensors(cache_sh, cspecs, mesh))
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["micro_scale"] = scale
    rec["flops"] = flops.get_total_flops() * scale
    rec["collectives"] = comms.record(scale)
    if save:
        RESULTS_DIR.mkdir(parents=True, exist_ok=True)
        out = RESULTS_DIR / f"{arch}__{shape_name}__{name}.json"
        out.write_text(json.dumps(rec, indent=1))
    if verbose:
        print(f"[dryrun] {arch:22s} {shape_name:12s} {name:8s} "
              f"trace={rec['trace_s']:6.1f}s flops={rec['flops']:.3e} "
              f"args={rec['arg_bytes'] / 2**30:.2f}GiB/rank "
              f"coll={rec['collectives']['total_bytes'] / 1e9:.2f}GB",
              flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="architecture id "
                    "(default: every assigned one)")
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--include-paper-model", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    if args.include_paper_model and "gboard-cifg-lstm" not in archs:
        archs.append("gboard-cifg-lstm")
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    dryrun_one(arch, shape, mp)
                except Exception as e:   # report every failing triple
                    failures.append((arch, shape, mp, repr(e)))
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f[:3], f[3][:200])
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
