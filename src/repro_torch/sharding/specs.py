"""Layouts over a mesh: the cohort's ownership rule and the production
step's model-parallel specs (the port of the reference's
``sharding/specs.py``).

**The cohort.** The reference shards the per-round cohort axis, and under
the sharded sampler the padded population axis, over the mesh's batch axes
— ``("data",)``, or ``("pod", "data")`` across pods — with one
``PartitionSpec`` for both (``cohort_spec`` / ``population_spec``). The
port runs one process per shard, so the spec becomes the rule it encodes:
with T = num_pods · num_shards ranks in pod-major order, rank
``r = pod · num_shards + data`` owns

* the cohort slots ``[r · padded / T, (r + 1) · padded / T)``, and
* the population rows ``[r · n_pad / T, (r + 1) · n_pad / T)``

(:func:`owned_rows`). Each range is a contiguous group of whole canonical
blocks, so a pod's ranks hold a contiguous group of blocks in block order.

**The production step** (`repro_torch.launch.steps`) lays parameters,
inputs and caches out MaxText-style, rule for rule the reference's:

* ``model``: tensor-parallel (Megatron) sharding of d_ff, the attention
  heads' flat H·hd / KV·hd output, the vocab, the experts and d_inner;
* ``data``: FSDP sharding of the other param dim, and one client (or batch
  row) per data row;
* ``pod``: the batch across pods; params are replicated across pods.

Where a dim does not divide the model axis the rules fall back as the
reference's do: KV caches shard their sequence, MoE shards the expert d_ff
instead of the experts. A spec is a :class:`Spec`, a tuple with one entry
per tensor dim: an axis name, a tuple of axis names (sharded over both,
the first major) or ``None``. The port's parameter and cache trees are
nested dicts keyed as the reference's, so a spec tree mirrors its tree by
key path; a parameter set's compute copies (``params["compute"]``) carry no
spec, because the step rebuilds them.

:func:`placements` turns a spec into DTensor placements over a
``DeviceMesh`` whose dims carry the axis names; :func:`distribute_params`
and :func:`gather_params` carry a parameter tree into that layout and back
to full tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from repro_torch.configs.base import InputShape, MeshConfig, ModelConfig
from repro_torch.utils.params import COMPUTE

__all__ = ["FSDP", "MP", "STACKED_ROOTS", "Spec", "batch_axes",
           "batch_axis_size", "batch_specs", "cache_specs",
           "distribute_params", "drop_fsdp",
           "gather_params", "owned_rows", "param_specs", "placements",
           "serving_param_specs", "sim_mesh_config", "spec_tree_map"]

STACKED_ROOTS = ("layers", "mamba_layers", "enc_layers", "dec_layers")

FSDP = "data"     # params FSDP-shard over data (replicated across pods)
MP = "model"


class Spec(tuple):
    """The port's ``PartitionSpec``: ``Spec("data", None)`` holds one entry
    per tensor dim — an axis name, a tuple of names or ``None``. A tuple of
    one name is that name, as ``PartitionSpec`` stores it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


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


# ------------------------------------------------------------ spec trees


def spec_tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, keeping its keys; the
    compute copies (``"compute"`` at the root) are left out."""
    if isinstance(tree, dict):
        return {k: spec_tree_map(fn, v, path + (k,))
                for k, v in tree.items() if not (not path and k == COMPUTE)}
    return fn(path, tree)


def _leaf_spec(names, leaf, cfg: ModelConfig, mp: int) -> Spec:
    """The spec of one param leaf (without the stacked-layer dim)."""
    name = names[-1]
    ssm_heads_ok = cfg.ssm_heads % mp == 0 if cfg.ssm_heads else False
    experts_ok = cfg.n_experts % mp == 0 if cfg.n_experts else False
    nd = len(leaf.shape) - (1 if names[0] in STACKED_ROOTS else 0)

    if name == "tok":
        # tied: vocab (model) × d (fsdp) serves both lookup and head
        return Spec(MP, FSDP) if cfg.tie_embeddings else Spec(FSDP, MP)
    if name == "head":
        return Spec(MP, FSDP)
    if name in ("wq", "wk", "wv"):
        # the flat H·hd and KV·hd outputs shard even where the heads do
        # not divide the axis (the reshape to heads reshards)
        return Spec(FSDP, MP)
    if name == "wo":
        return Spec(MP, FSDP)
    if name in ("w_gate", "w_up"):
        if nd == 3:  # MoE expert-stacked
            return (Spec(MP, FSDP, None) if experts_ok
                    else Spec(None, FSDP, MP))
        return Spec(FSDP, MP)
    if name == "w_down":
        if nd == 3:
            return (Spec(MP, None, FSDP) if experts_ok
                    else Spec(None, MP, FSDP))
        return Spec(MP, FSDP)
    if name == "w_in":
        return Spec(FSDP, MP)
    if name == "w_out":  # gelu-MLP down proj and the Mamba out proj
        return Spec(MP, FSDP)
    if name == "b_in":
        return Spec(MP)
    if name == "b_out":
        return Spec(None)
    if name in ("w_z", "w_x"):  # Mamba in-proj and the CIFG input gates
        return Spec(FSDP, MP)
    if name in ("w_B", "w_C", "w_dt"):
        return Spec(FSDP, None)
    if name == "conv_x":
        return Spec(None, MP)
    if name in ("conv_B", "conv_C"):
        return Spec(None, None)
    if name == "conv_b_x":
        return Spec(MP)
    if name in ("conv_b_B", "conv_b_C"):
        return Spec(None)
    if name in ("A_log", "dt_bias", "D"):
        return Spec(MP) if ssm_heads_ok else Spec(None)
    if name == "w":  # MoE router
        return Spec(FSDP, None)
    if name in ("w_h", "w_gates"):  # CIFG recurrent / legacy fused
        return Spec(FSDP, MP)
    if name == "b_gates":
        return Spec(MP)
    if name == "w_proj":
        return Spec(MP, FSDP)
    if name in ("scale", "bias"):
        if len(names) >= 2 and names[-2] == "norm" and "mixer" in names:
            return Spec(MP)  # Mamba's gated norm over the sharded d_inner
        return Spec(*([None] * nd))
    return Spec(*([None] * nd))


def param_specs(params_shape, cfg: ModelConfig, mesh_cfg: MeshConfig):
    """The spec tree of a parameter tree (tensors of any device, ``meta``
    included: only shapes are read)."""
    mp = _axis_sizes(mesh_cfg)[MP]

    def one(names, leaf):
        spec = _leaf_spec(names, leaf, cfg, mp)
        if names[0] in STACKED_ROOTS:
            spec = Spec(None, *spec)
        if len(spec) != len(leaf.shape):
            raise ValueError(f"param_specs: {'.'.join(names)} has shape "
                             f"{tuple(leaf.shape)} but spec {spec}")
        return spec

    return spec_tree_map(one, params_shape)


def batch_specs(cfg: ModelConfig, shape: InputShape, mesh_cfg: MeshConfig,
                batch_size: int = None) -> Dict[str, Any]:
    """Input specs for a global batch of ``shape``."""
    b = shape.global_batch if batch_size is None else batch_size
    dp = batch_axes(mesh_cfg)
    bspec = dp if b % batch_axis_size(mesh_cfg) == 0 else None
    out = {"tokens": Spec(bspec, None), "labels": Spec(bspec, None)}
    if cfg.family == "encdec":
        out["frames"] = Spec(bspec, None, None)
    if cfg.family == "vlm":
        out["image_embeds"] = Spec(bspec, None, None)
    return out


def cache_specs(cache_shape, cfg: ModelConfig, shape: InputShape,
                mesh_cfg: MeshConfig):
    """The spec tree of a decode cache: KV over ``model`` where the KV
    heads divide it, else over the sequence where that divides, else
    replicated."""
    mp = _axis_sizes(mesh_cfg)[MP]
    dp = batch_axes(mesh_cfg)
    b = shape.global_batch
    bspec = dp if b % batch_axis_size(mesh_cfg) == 0 else None
    kv_ok = cfg.n_kv_heads % mp == 0
    seq_ok = shape.seq_len % mp == 0
    ssm_ok = cfg.ssm_heads % mp == 0 if cfg.ssm_heads else False
    di_ok = (cfg.ssm_expand * cfg.d_model) % mp == 0

    def one(names, leaf):
        name = names[-1]
        if name in ("k", "v"):
            if kv_ok:
                return Spec(None, bspec, None, MP, None)
            if seq_ok:
                return Spec(None, bspec, MP, None, None)
            return Spec(None, bspec, None, None, None)
        if name in ("xk", "xv"):  # whisper's cross-attention memory
            return Spec(None, bspec, None, None, None)
        if name == "ssm":
            return Spec(None, bspec, MP if ssm_ok else None, None, None)
        if name == "conv_x":
            return Spec(None, bspec, None, MP if di_ok else None)
        if name in ("conv_B", "conv_C"):
            return Spec(None, bspec, None, None)
        if name in ("h", "c"):  # lstm
            return Spec(bspec, None)
        if name == "pos":
            return Spec()
        return Spec(*([None] * len(leaf.shape)))

    return spec_tree_map(one, cache_shape)


def drop_fsdp(spec: Spec) -> Spec:
    """``spec`` with the FSDP axis taken out of every entry."""
    def one(e):
        if e == FSDP:
            return None
        if isinstance(e, tuple):
            kept = tuple(a for a in e if a != FSDP)
            return kept if kept else None
        return e
    return Spec(*[one(e) for e in spec])


def serving_param_specs(params_shape, cfg: ModelConfig,
                        mesh_cfg: MeshConfig):
    """The TP-only serving layout: the FSDP axis dropped, so a decode step
    gathers no weights, at ``data``-times more parameter memory a rank."""
    return spec_tree_map(lambda _, s: drop_fsdp(s),
                         param_specs(params_shape, cfg, mesh_cfg))


# ---------------------------------------------------------- DTensor side


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` over ``mesh`` (a ``DeviceMesh`` with
    ``mesh_dim_names``): ``Shard(d)`` on every mesh dim that tensor dim
    ``d`` names, ``Replicate()`` on the others. A dim sharded over several
    axes (``("pod", "data")``) shards over them in the mesh's order, the
    first the major, as `owned_rows` lays ranks out."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    where: Dict[str, int] = {}
    for d, e in enumerate(spec):
        axes = e if isinstance(e, tuple) else (() if e is None else (e,))
        if tuple(sorted(axes, key=names.index)) != tuple(axes):
            raise ValueError(f"placements: {spec} shards dim {d} over {e}, "
                             f"not in the mesh's order {names}")
        for a in axes:
            if a not in names:
                raise ValueError(f"placements: axis {a!r} of {spec} is not "
                                 f"a dim of the mesh {names}")
            where[a] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def distribute_params(params, specs, mesh):
    """``params`` (full tensors, the same on every rank) as DTensors over
    ``mesh`` in ``specs``' layout. Each rank keeps a copy of its own slice
    (a step that updates in place leaves ``params`` as they were); nothing
    is sent. The compute copies are dropped."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(names, t):
        spec = specs
        for k in names:
            spec = spec[k]
        d = distribute_tensor(t.detach(), mesh, placements(spec, mesh),
                              src_data_rank=None)
        return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())

    return spec_tree_map(one, params)


def gather_params(params):
    """The inverse of :func:`distribute_params`: every DTensor leaf as its
    full tensor (plain tensors pass through)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.mesh import host_routed_collectives

    def one(_, t):
        if not isinstance(t, DTensor):
            return t
        with host_routed_collectives(t.device_mesh):
            return t.full_tensor()

    return spec_tree_map(one, params)
