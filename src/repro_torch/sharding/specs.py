"""The cohort's layout over the batch axes of a mesh (the cohort part of
the reference's ``sharding/specs.py``).

The reference shards the per-round cohort axis, and under the sharded
sampler the padded population axis, over the mesh's batch axes —
``("data",)``, or ``("pod", "data")`` across pods — with one
``PartitionSpec`` for both (``cohort_spec`` / ``population_spec``). The
port runs one process per shard, so the spec becomes the rule it encodes:
with T = num_pods · num_shards ranks in pod-major order, rank
``r = pod · num_shards + data`` owns

* the cohort slots ``[r · padded / T, (r + 1) · padded / T)``, and
* the population rows ``[r · n_pad / T, (r + 1) · n_pad / T)``

(:func:`owned_rows`). Each range is a contiguous group of whole canonical
blocks, so a pod's ranks hold a contiguous group of blocks in block order.

The model-parallel specs (``param_specs``, ``batch_specs``,
``cache_specs``, ``serving_param_specs``) belong to the production step,
which is not ported yet (ROADMAP.md, queue A, item 8).
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs.base import MeshConfig

__all__ = ["batch_axes", "batch_axis_size", "owned_rows", "sim_mesh_config"]


def _axis_sizes(mesh_cfg: MeshConfig) -> Dict[str, int]:
    return dict(zip(mesh_cfg.axes, mesh_cfg.shape))


def batch_axes(mesh_cfg: MeshConfig):
    """Axes the client/batch dimension shards over."""
    return ("pod", "data") if "pod" in mesh_cfg.axes else ("data",)


def batch_axis_size(mesh_cfg: MeshConfig) -> int:
    sizes = _axis_sizes(mesh_cfg)
    n = 1
    for a in batch_axes(mesh_cfg):
        n *= sizes[a]
    return n


def sim_mesh_config(num_shards: int, num_pods: int = 1) -> MeshConfig:
    """The cohort mesh of the simulation engine
    (`repro_torch.fl.engine.SimEngine(num_shards=..., num_pods=...)`): the
    1-D ``(data,)`` layout, or with ``num_pods > 1`` the 2-D
    ``(pod, data)`` batch slice of the multi-pod production mesh."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if num_pods < 1:
        raise ValueError(f"num_pods must be >= 1, got {num_pods}")
    if num_pods == 1:
        return MeshConfig((num_shards,), ("data",))
    return MeshConfig((num_pods, num_shards), ("pod", "data"))


def owned_rows(n: int, rank: int, total: int) -> Tuple[int, int]:
    """``[start, stop)`` of the rows of an axis of length ``n`` (a padded
    cohort or a padded population, a multiple of ``total``) that pod-major
    rank ``rank`` of ``total`` owns."""
    if n % total:
        raise ValueError(f"an axis of {n} rows does not split over {total} "
                         "ranks; pad it to whole canonical blocks first")
    per = n // total
    return rank * per, (rank + 1) * per
