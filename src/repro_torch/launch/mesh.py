"""Meshes and ranks of the port (the reference's ``launch/mesh.py``, and
what ``torch.distributed`` needs around it).

The reference lays devices of one process out in a ``jax`` mesh. The port
runs one process per rank, started by ``torchrun`` (``python -m
torch.distributed.run``) or by :func:`spawn_ranks`, and lays the ranks out
in a ``torch.distributed.device_mesh.DeviceMesh``:

* :func:`init_distributed` joins the process group the launcher set up
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and puts the rank on
  ``cuda:(LOCAL_RANK % device_count)``, or on the CPU when asked;
* :func:`make_cohort_mesh` lays the ranks out pod-major over the cohort's
  batch axes, ``("data",)`` or ``("pod", "data")``, so rank
  ``pod · num_shards + data`` sits at mesh coordinate ``(pod, data)``;
* :func:`all_gather_copies` gathers a tensor over one mesh axis. It
  carries copies only: no collective here adds anything, so a sum folded
  after the gather keeps the canonical association.

The backend is the caller's choice, ``nccl`` or ``gloo``, and is never
swapped for another when one fails. NCCL refuses two ranks on one device,
so ranks that share a card run on ``gloo``; gloo gathers host tensors, and
its CUDA tensors go through host memory (:func:`all_gather_copies`, and
for DTensor's own collectives :func:`host_routed_collectives`).
"""
from __future__ import annotations

import contextlib
import functools
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig
from repro_torch.utils.device import resolve_device

__all__ = ["BACKENDS", "COHORT_AXES", "all_gather_copies",
           "host_routed_collectives", "init_distributed", "make_cohort_mesh",
           "make_production_mesh", "mesh_config", "one_rank", "spawn_ranks"]

# Axis layouts make_cohort_mesh accepts: the cohort's batch axes only (the
# 1-D sim layout, or the multi-pod batch slice of the production mesh).
COHORT_AXES = (("data",), ("pod", "data"))

BACKENDS = ("nccl", "gloo")


def _mesh(device_type: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Tuple[int, ...]] = None,
                         device_type: str = "cuda"):
    """The production mesh over the running ranks: ``(data, model)`` or,
    with ``multi_pod``, ``(pod, data, model)``. ``shape`` overrides the
    counts (same axis order) and must keep one entry per axis."""
    cfg = mesh_config(multi_pod=multi_pod)
    shape = cfg.shape if shape is None else tuple(shape)
    if len(shape) != len(cfg.axes):
        raise ValueError(
            f"make_production_mesh: shape {shape} must have one entry per "
            f"axis {cfg.axes}")
    return _mesh(device_type, shape, cfg.axes)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_cohort_mesh(mesh_cfg: MeshConfig, device_type: str = "cuda"):
    """The ``DeviceMesh`` of the simulation engine's sharded cohort: the
    1-D ``(data,)`` layout or the 2-D ``(pod, data)`` batch slice of the
    multi-pod production mesh, over exactly ``mesh_cfg.n_devices`` running
    ranks in pod-major order. Model-parallel axes stay the launch layer's
    job, so a config carrying a ``model`` axis is refused."""
    if tuple(mesh_cfg.axes) not in COHORT_AXES:
        raise ValueError(
            "make_cohort_mesh expects a cohort MeshConfig over the batch "
            f"axes only — ('data',) or ('pod', 'data') — got {mesh_cfg}. "
            "Model-parallel axes are the launch layer's job; build the "
            "cohort slice with sharding.specs.sim_mesh_config(num_shards, "
            "num_pods).")
    n = mesh_cfg.n_devices
    running = dist.get_world_size() if dist.is_initialized() else 1
    if running < n:
        raise ValueError(
            f"cohort mesh needs {n} ranks but only {running} are running. "
            "Start one process per rank: python -m torch.distributed.run "
            f"(torchrun) --nproc-per-node {n}, or "
            "repro_torch.launch.mesh.spawn_ranks.")
    if running > n:
        raise ValueError(
            f"cohort mesh takes {n} ranks (num_pods x num_shards) but "
            f"{running} are running; launch with torchrun --nproc-per-node "
            f"{n}")
    return _mesh(device_type, mesh_cfg.shape, mesh_cfg.axes)


def all_gather_copies(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along the leading axis
    in group-rank order: (k, ...) → (group size · k, ...). On ``gloo`` a
    CUDA tensor is copied to the host, gathered there and copied back."""
    x = x.contiguous()
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo" and x.device.type == "cuda":
        host = x.cpu()
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts).to(x.device)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


# DTensor's functional collectives (each takes the tensor first) and the
# position of their group argument
_ROUTED = {"all_reduce": 2, "all_gather_tensor": 2, "all_gather_single": 2,
           "reduce_scatter_tensor": 3, "reduce_scatter_single": 3,
           "all_to_all_single": 3}


def _group_size(group) -> int:
    """The rank count of a functional collective's ``group`` argument."""
    if isinstance(group, tuple):                  # (mesh, mesh dim)
        return group[0].size(group[1])
    if hasattr(group, "mesh_dim_names"):          # a 1-D DeviceMesh
        return group.size()
    if isinstance(group, str):                    # a group's name
        from torch.distributed.distributed_c10d import \
            _resolve_process_group
        return _resolve_process_group(group).size()
    if isinstance(group, list):                   # the ranks
        return len(group)
    return dist.get_world_size(group)


def _via_host(fn, group_at: int):
    @functools.wraps(fn)
    def routed(x, *args, **kw):
        if not x.is_cuda:
            return fn(x, *args, **kw)
        group = kw["group"] if "group" in kw else args[group_at - 1]
        if _group_size(group) == 1:      # the identity: stays on the card
            return x.clone()
        out = fn(x.cpu(), *args, **kw)
        return (out.wait() if hasattr(out, "wait") else out).to(x.device)
    return routed


def _alltoall_via_host(x, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's shard-to-shard move as gloo runs it on the CPU: gather on
    the host, keep this rank's chunk."""
    import torch.distributed._functional_collectives as funcol
    if mesh.size(mesh_dim) == 1:
        return x.contiguous().clone()
    full = funcol.all_gather_tensor(x.cpu().contiguous(), gather_dim,
                                    (mesh, mesh_dim))
    full = full.wait() if hasattr(full, "wait") else full
    part = torch.chunk(full, mesh.size(mesh_dim), dim=shard_dim)
    return part[mesh.get_local_rank(mesh_dim)].contiguous().to(x.device)


@contextlib.contextmanager
def host_routed_collectives(mesh):
    """Inside: DTensor's collectives over ``mesh`` carry CUDA tensors
    through host memory when the ranks run on gloo, as
    :func:`all_gather_copies` does (a probe of gloo's own collectives on
    CUDA tensors crashed the ranks on an H100; its host ones are sound). The compute stays on the
    card; only the collective's payload is copied. A collective over one
    rank is the identity and stays on the card. A no-op for a CPU mesh and
    for any backend but gloo."""
    if mesh.device_type != "cuda" or dist.get_backend() != "gloo":
        yield
        return
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import _collective_utils, placement_types
    saved = [(funcol, n, getattr(funcol, n)) for n in _ROUTED
             if hasattr(funcol, n)]
    at = dict(_ROUTED)
    saved += [(m, "shard_dim_alltoall", m.shard_dim_alltoall)
              for m in (_collective_utils, placement_types)
              if hasattr(m, "shard_dim_alltoall")]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, _alltoall_via_host
                    if name == "shard_dim_alltoall"
                    else _via_host(fn, at[name]))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def init_distributed(backend: str = "nccl", device=None,
                     init_method: str = "env://") -> torch.device:
    """Join the process group of a launched rank and return its device.

    Reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` (``torchrun`` sets
    them, and ``MASTER_ADDR`` / ``MASTER_PORT`` for ``env://``). ``device``
    ``"cpu"`` keeps the rank on the CPU (``gloo`` only); otherwise the rank
    takes ``cuda:(LOCAL_RANK % device_count)`` and raises without a GPU.
    ``backend`` is ``"nccl"`` or ``"gloo"``, as given: NCCL cannot run two
    ranks on one card, and asking it to raises here rather than switching
    to gloo."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    env = os.environ
    if "WORLD_SIZE" not in env or "RANK" not in env:
        raise RuntimeError(
            "RANK / WORLD_SIZE are not set: start the ranks with python -m "
            "torch.distributed.run (torchrun) --nproc-per-node N, or with "
            "repro_torch.launch.mesh.spawn_ranks")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > count:
            raise ValueError(
                f"nccl cannot run {local_world} ranks on {count} card(s): it "
                "refuses two ranks on one device. Run ranks that share a "
                "card on --dist-backend gloo")
    elif backend == "nccl":
        raise ValueError("nccl needs CUDA devices; ranks on the CPU run on "
                         "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return dev


@contextlib.contextmanager
def one_rank(device=None):
    """This process alone as a gloo process group (world size 1, a file
    rendezvous in a temporary directory), for a (1, 1) mesh without a
    launcher; yields the rank's device and destroys the group on exit."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/pg",
                                rank=0, world_size=1)
        try:
            yield dev
        finally:
            dist.destroy_process_group()


def _rank_main(fn: Callable, rank: int, world: int, backend: str, device,
               tmp: str, args: Sequence) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    out = Path(tmp)
    try:
        dev = init_distributed(backend, device,
                               init_method=f"file://{out / 'pg'}")
        try:
            result = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn_ranks(fn: Callable, world: int, args: Sequence = (), *,
                backend: str = "gloo", device=None,
                timeout: float = 1800.0) -> List:
    """Run ``fn(device, *args)`` on ``world`` local processes, one rank
    each, joined in one process group on ``backend`` (a file rendezvous in
    a temporary directory, so parallel callers never share a port), and
    return the ranks' results in rank order. ``fn`` and ``args`` are
    pickled: ``fn`` must be importable, by a module that the spawned
    processes can import. If a rank fails, the others are stopped and the
    failure's traceback raised."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, device, tmp,
                                   tuple(args)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join(10)
        errs = [Path(tmp, f"rank{r}.err") for r in range(world)]
        if any(p.exitcode != 0 for p in procs):
            msgs = [f"rank {r}:\n{e.read_text()}"
                    for r, e in enumerate(errs) if e.exists()]
            raise RuntimeError(
                f"spawn_ranks: exit codes {[p.exitcode for p in procs]}"
                + ("\n" + "\n".join(msgs) if msgs else
                   f" (no traceback; timeout {timeout} s)"))
        return [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
