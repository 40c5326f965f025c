"""Production-shape distributed steps: the DP-FedAvg training round, the
prefill and the decode step over the production mesh (the port of the
reference's ``launch/steps.py``), on ``torch.distributed.tensor``
(DTensor).

``make_fed_train_step`` is Algorithm 1 at production shape: the global
batch of ``train_4k`` is 256 *clients* (one local E = 1 step each), laid
out one per batch row of the mesh (``data``, or ``pod`` × ``data``). The
parameters are DTensors in the `specs.param_specs` layout (FSDP over
``data`` × tensor-parallel over ``model``, replicated over ``pod``). The
step runs, as the reference's:

1. the compute copies: every float32 leaf cast to bfloat16;
2. C // rows microbatches, ``rows = batch_axis_size`` (one client per
   batch row, the reference's default ``clients_per_row = 1``); client
   ``i · rows + r`` sits on batch row ``r`` of microbatch ``i``.
   Per microbatch the copies are gathered over ``data`` into the client
   layout (`specs.drop_fsdp`: the FSDP dim whole, the TP dims kept, the
   reference's ``_client_grad_spec``), and each batch row takes its own
   clients: the model runs on DTensors over the row's ``model`` axis, so
   one client's gradient is live per rank at a time, model-sharded;
3. each client's update is clipped: the float32 sum of squares of its
   model-sharded gradient is all-reduced over ``model``, ‖Δ‖ = η_c‖g‖,
   factor = min(1, S / max(‖Δ‖, 1e-12)), weight w = −η_c · factor;
4. the weighted client sum (float32) is reduce-scattered over ``data``
   (and summed over ``pod``) into the round sum, in the param layout;
5. the round ends with sum / C + σ·N(0, 1), σ = zS/C, the noise drawn leaf
   by leaf in tree order from an explicit ``torch.Generator`` at the full
   leaf shape on every rank, each rank keeping its own slice (so the noise
   does not depend on the layout); then the Nesterov server step
   m′ = μm + d, p′ = p + lr_s(μm′ + d), in place (the reference donates
   its params and opt state), and ``count`` + 1.

`fed_train_step_plain` is the same computation with no mesh: what the
one-rank (1, 1) step is held to bitwise.

``make_prefill_step`` / ``make_decode_step`` serve from params in the
`param_specs` layout (gathered over ``data`` into the TP layout, the
model's compute copies made from them); the cache comes out in the
`specs.cache_specs` layout and the logits as ``(batch axes or None,
"model")``.

Every step runs its model under DTensor's implicit replication (the
models make plain index and position tensors, replicated by
construction) and, on gloo with CUDA tensors, with DTensor's collectives
carried through host memory (`mesh.host_routed_collectives`). The kernels
run on each rank's local shards (`repro_torch.sharding.kernel_map`).

The stand-ins for shapes (`input_specs`, `params_shape`, `opt_state_shape`,
`cache_shape`) are ``meta`` tensors: nothing is allocated.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import (DPConfig, InputShape, MeshConfig,
                                      ModelConfig)
from repro_torch.core.server_optim import ServerOptState
from repro_torch.launch.mesh import host_routed_collectives
from repro_torch.models.api import Model
from repro_torch.sharding import specs as SP
from repro_torch.utils.params import strip_compute, with_compute_copies
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

__all__ = ["cache_shape", "fed_train_step_plain", "input_specs",
           "make_decode_step", "make_fed_train_step", "make_prefill_step",
           "opt_state_shape", "params_shape"]


# ---------------------------------------------------------------------------
# shape stand-ins (meta tensors: no allocation)
# ---------------------------------------------------------------------------


def _meta(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")


def _traced_meta(fn: Callable):
    """``fn()``'s tree of tensors as ``meta`` tensors, traced under
    ``FakeTensorMode`` so that nothing is drawn or allocated (the truncated
    normal, whose rejection bounds read values, leaves its fake tensor as
    it is)."""
    from unittest import mock

    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), mock.patch.object(
            torch.nn.init, "trunc_normal_", lambda t, *a, **k: t):
        out = fn()
    return tree_map(_meta, out)


def input_specs(cfg: ModelConfig, shape: InputShape
                ) -> Dict[str, torch.Tensor]:
    """Model inputs of one step of ``shape`` as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind == "decode":   # one new token against a seq_len cache
        return {"tokens": sds((b,), i32)}
    out = {"tokens": sds((b, s), i32)}
    if shape.kind == "train":
        out["labels"] = sds((b, s), i32)
    if cfg.family == "encdec":
        out["frames"] = sds((b, cfg.n_audio_frames, cfg.d_model), bf16)
    if cfg.family == "vlm":
        out["image_embeds"] = sds((b, cfg.n_image_tokens, cfg.d_model), bf16)
    return out


def params_shape(model: Model):
    """The model's parameter tree (without compute copies) as meta
    tensors."""
    return _traced_meta(lambda: strip_compute(
        model.init(torch.Generator(), device="cpu")))


def opt_state_shape(params_sh) -> ServerOptState:
    f32 = lambda t: tree_map(
        lambda l: torch.empty(tuple(l.shape), dtype=torch.float32,
                              device="meta"), t)
    return ServerOptState(momentum=f32(params_sh), nu=f32(params_sh),
                          count=torch.empty((), dtype=torch.int32,
                                            device="meta"))


def cache_shape(model: Model, shape: InputShape):
    """The decode cache of ``shape`` as meta tensors."""
    return _traced_meta(lambda: model.init_cache(
        shape.global_batch, shape.seq_len, device="cpu"))


# ---------------------------------------------------------------------------
# DTensor helpers
# ---------------------------------------------------------------------------


def _implicit():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _spec_at(specs, names):
    for k in names:
        specs = specs[k]
    return specs


def _batch_coord(mesh, mesh_cfg: MeshConfig) -> int:
    """This rank's row over the mesh's batch axes (pod-major)."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh_cfg.axes, mesh_cfg.shape))
    b = 0
    for a in SP.batch_axes(mesh_cfg):
        b = b * sizes[a] + coord[a]
    return b


def _model_placement(spec, mesh):
    """The placement ``spec`` gives the ``model`` dim of ``mesh``."""
    return SP.placements(spec, mesh)[mesh.mesh_dim_names.index(SP.MP)]


def _on_model_mesh(t, spec, mesh):
    """A DTensor over ``mesh`` → its rank-local view as a DTensor over the
    ``model`` axis alone, in ``spec``'s model placement. ``t`` must already
    be whole over the other axes (or hold this rank's rows of them)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t.to_local(), mesh[SP.MP],
                              (_model_placement(spec, mesh),),
                              run_check=False)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's slice of a full tensor, held alike on every rank."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(full, mesh, placements,
                             src_data_rank=None).to_local()


# ---------------------------------------------------------------------------
# DP-FedAvg production train step
# ---------------------------------------------------------------------------


def _cast(leaf: torch.Tensor) -> torch.Tensor:
    """The reference's compute copy: float32 → bfloat16, others as they
    are."""
    return leaf.to(torch.bfloat16) if leaf.dtype == torch.float32 else leaf


def _client_batch(batch, c: int):
    return {k: v[c:c + 1] for k, v in batch.items()}


def _clip(ss, clip_S: float, client_lr: float):
    """(‖Δ‖, clipped ∈ {0, 1}, weight) of one client from its gradient's
    float32 sum of squares."""
    norm = torch.sqrt(ss) * client_lr               # ‖Δ‖ = η_c‖g‖ (E = 1)
    factor = torch.clamp(clip_S / torch.clamp(norm, min=1e-12), max=1.0)
    return norm, (factor < 1.0).float(), factor * (-client_lr)


def _server_leaf(p, m, d, dp: DPConfig):
    """Nesterov on one leaf, in place: m′ = μm + d, p′ = p + lr_s(μm′ + d).
    Returns (p′, m′)."""
    mu, lr_s = dp.server_momentum, dp.server_lr
    m.mul_(mu).add_(d)
    p.add_(lr_s * (mu * m + d))
    return p, m


def _noise(shape, generator: torch.Generator, dev) -> torch.Tensor:
    """N(0, 1) of a leaf's full shape, drawn from ``generator`` on its
    device, on ``dev``."""
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32, device=generator.device).to(dev)


def _check_dp(dp: DPConfig, shape: InputShape, rows: int):
    if dp.server_opt != "momentum" or not dp.nesterov:
        raise ValueError("the production step's server update is Nesterov "
                         f"momentum (got server_opt={dp.server_opt!r}, "
                         f"nesterov={dp.nesterov})")
    if shape.global_batch % rows:
        raise ValueError(f"{shape.global_batch} clients do not split into "
                         f"microbatches of {rows} rows")


def _metrics(sums: torch.Tensor, C: int, sigma: float) -> Dict:
    return {"loss": sums[0] / C, "mean_update_norm": sums[1] / C,
            "frac_clipped": sums[2] / C,
            "noise_std": torch.tensor(sigma, dtype=torch.float32,
                                      device=sums.device)}


def fed_train_step_plain(model: Model, dp: DPConfig, params, opt_state,
                         batch, generator: torch.Generator, *,
                         client_lr: float = 0.5):
    """The production step's computation with no mesh (one batch row, one
    client per microbatch): plain tensors in, plain tensors out (the params
    and momentum updated in place), the same
    operations in the same order as `make_fed_train_step` on a (1, 1)
    mesh."""
    C = next(iter(batch.values())).shape[0]
    _check_dp(dp, InputShape("plain", 0, C, "train"), 1)
    params = strip_compute(params)
    leaves = tree_leaves(params)
    copies = [_cast(l) for l in leaves]
    acc = [torch.zeros_like(l, dtype=torch.float32) for l in leaves]
    sums = torch.zeros(3, dtype=torch.float32, device=leaves[0].device)
    for c in range(C):
        wrt = [t.detach().requires_grad_() for t in copies]
        loss = model.loss_fn(tree_unflatten(params, wrt),
                             _client_batch(batch, c))
        grads = torch.autograd.grad(loss, wrt)
        ss = torch.stack([g.float().square().sum() for g in grads]).sum()
        norm, clipped, w = _clip(ss, dp.clip_norm, client_lr)
        for k, g in enumerate(grads):
            acc[k] = acc[k] + w * g.float()
        del grads
        sums = sums + torch.stack([loss.detach(), norm, clipped])
    sigma = dp.noise_multiplier * dp.clip_norm / C
    new_p, new_m = [], []
    for p, m, a in zip(leaves, tree_leaves(opt_state.momentum), acc):
        d = a / C + sigma * _noise(a.shape, generator, a.device)
        p, m = _server_leaf(p, m, d, dp)
        new_p.append(p)
        new_m.append(m)
    del acc
    state = opt_state._replace(momentum=tree_unflatten(params, new_m),
                               count=opt_state.count + 1)
    return tree_unflatten(params, new_p), state, _metrics(sums, C, sigma)


def make_fed_train_step(model: Model, dp: DPConfig, mesh,
                        mesh_cfg: MeshConfig, pspecs, shape: InputShape, *,
                        client_lr: float = 0.5):
    """``step(params, opt_state, batch, generator) → (params, opt_state,
    metrics)`` over ``mesh`` (a ``DeviceMesh`` with ``mesh_cfg.axes``).

    ``params`` and ``opt_state.momentum`` are DTensor trees in ``pspecs``'
    layout (`specs.distribute_params`); ``batch`` holds the global batch
    (C, S) as plain tensors alike on every rank, or as DTensors;
    ``generator`` draws the noise (the same seed on every rank). The params
    and momentum are updated in place. The metrics
    are ``loss``, ``mean_update_norm``, ``frac_clipped`` and ``noise_std``,
    0-d float32 tensors. ``step(..., n_micro=k)`` runs the first k
    microbatches only (the dry run traces one and scales)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    rows = SP.batch_axis_size(mesh_cfg)
    C = shape.global_batch
    _check_dp(dp, shape, rows)
    if tuple(mesh.mesh_dim_names) != tuple(mesh_cfg.axes):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} are not "
                         f"{mesh_cfg.axes}")
    n_micro = C // rows
    sigma = dp.noise_multiplier * dp.clip_norm / C
    dp_dims = set(SP.batch_axes(mesh_cfg))
    names = list(mesh.mesh_dim_names)
    model_mesh = mesh[SP.MP]

    spec_leaves = [_spec_at(pspecs, p) for p in _paths(pspecs)]
    param_pl = [SP.placements(s, mesh) for s in spec_leaves]
    client_pl = [SP.placements(SP.drop_fsdp(s), mesh)
                 for s in spec_leaves]
    sharded = [not isinstance(_model_placement(s, mesh), Replicate)
               for s in spec_leaves]
    # a client sum on a batch row: partial over the batch axes, the TP
    # layout over model
    partial_pl = [tuple(Partial() if n in dp_dims else pl[i]
                        for i, n in enumerate(names)) for pl in client_pl]
    metric_pl = tuple(Partial() if n in dp_dims else Replicate()
                      for n in names)
    brow = _batch_coord(mesh, mesh_cfg)

    def step(params, opt_state, batch, generator: torch.Generator, *,
             n_micro: int = n_micro):
        params = strip_compute(params)
        leaves = tree_leaves(params)
        dev = leaves[0].to_local().device
        with host_routed_collectives(mesh), _implicit():
            batch = {k: _full(v).to(dev) for k, v in batch.items()}
            copies = [_cast(l) for l in leaves]
            acc = [DTensor.from_local(
                torch.zeros_like(l.to_local(), dtype=torch.float32), mesh,
                l.placements, run_check=False) for l in leaves]
            sums = torch.zeros(3, dtype=torch.float32, device=dev)
            shard_mask = torch.tensor(sharded, dtype=torch.float32,
                                      device=dev)
            for i in range(n_micro):
                # FSDP gather: the copies whole over data, TP over model
                local = [DTensor.from_local(
                    c.redistribute(mesh, pl).to_local(), model_mesh,
                    (_model_placement(s, mesh),), run_check=False)
                    for c, pl, s in zip(copies, client_pl, spec_leaves)]
                # this batch row's client of microbatch i
                wrt = [t.detach().requires_grad_() for t in local]
                loss = model.loss_fn(tree_unflatten(params, wrt),
                                     _client_batch(batch, i * rows + brow))
                grads = torch.autograd.grad(loss, wrt)
                grads = [g.redistribute(model_mesh, t.placements)
                         for g, t in zip(grads, wrt)]
                g_local = [g.to_local() for g in grads]
                del grads, wrt, local
                per_leaf = torch.stack(
                    [g.float().square().sum() for g in g_local])
                mp_sum = DTensor.from_local(
                    per_leaf * shard_mask, model_mesh, (Partial(),),
                    run_check=False).full_tensor()
                ss = (mp_sum + per_leaf * (1.0 - shard_mask)).sum()
                norm, clipped, w = _clip(ss, dp.clip_norm, client_lr)
                sums = sums + torch.stack([_full(loss.detach()), norm,
                                           clipped])
                # leaf by leaf, the weighted client gradient
                # reduce-scattered into the round sum's param layout
                for k in range(len(acc)):
                    acc[k] = acc[k] + DTensor.from_local(
                        w * g_local[k].float(), mesh, partial_pl[k],
                        run_check=False).redistribute(mesh, param_pl[k])
                del g_local
            sums = DTensor.from_local(sums, mesh, metric_pl,
                                      run_check=False).full_tensor()
            new_p, new_m = [], []
            for p, m, a, pl in zip(leaves, tree_leaves(opt_state.momentum),
                                   acc, param_pl):
                noise = _local_slice(_noise(a.shape, generator, dev), mesh,
                                     pl)
                d = DTensor.from_local(a.to_local() / C + sigma * noise,
                                       mesh, pl, run_check=False)
                p, m = _server_leaf(p, m, d, dp)
                new_p.append(p)
                new_m.append(m)
            del acc
        state = opt_state._replace(momentum=tree_unflatten(params, new_m),
                                   count=opt_state.count + 1)
        return tree_unflatten(params, new_p), state, _metrics(sums, C, sigma)

    return step


def _paths(tree, path=()):
    """Leaf key paths of a nested dict in `tree_leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], path + (k,))]
    return [path]


# ---------------------------------------------------------------------------
# serving steps
# ---------------------------------------------------------------------------


def _serving_view(params, pspecs, mesh, model: Model):
    """Params in ``pspecs``' layout → the model's view over the ``model``
    axis: gathered over ``data`` into the TP layout, with the model's own
    compute copies made from them."""
    tp = {}
    for path in _paths(strip_compute(params)):
        spec = _spec_at(pspecs, path)
        t = _spec_at(params, path).redistribute(
            mesh, SP.placements(SP.drop_fsdp(spec), mesh))
        node = tp
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _on_model_mesh(t, spec, mesh)
    return with_compute_copies(tp, model.cfg.compute_dtype,
                               model.compute_copies)


def _row_dims(specs, bspec):
    """Per cache leaf, the dim that holds the batch rows (the spec entry
    ``bspec``), or None."""
    def one(_, spec):
        return next((d for d, e in enumerate(spec)
                     if bspec is not None and e == bspec), None)
    return SP.spec_tree_map(one, specs)


class _Layout:
    """How a serving step's batch, logits and cache lie over the mesh."""

    def __init__(self, model: Model, mesh, mesh_cfg: MeshConfig,
                 shape: InputShape):
        from torch.distributed.tensor import Replicate, Shard
        self.mesh = mesh
        dp = SP.batch_axes(mesh_cfg)
        self.nb = SP.batch_axis_size(mesh_cfg)
        self.b_ok = shape.global_batch % self.nb == 0
        self.bspec = SP.Spec(dp)[0] if self.b_ok else None
        self.brow = _batch_coord(mesh, mesh_cfg)
        self.cspecs = SP.cache_specs(cache_shape(model, shape), model.cfg,
                                     shape, mesh_cfg)
        self.row_dims = _row_dims(self.cspecs, self.bspec)
        self.logits_spec = SP.Spec(self.bspec, SP.MP)
        self.dp_dims = set(dp)
        self._shard, self._rep = Shard, Replicate

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global batch tensor."""
        t = _full(t)
        if not self.b_ok:
            return t
        per = t.shape[0] // self.nb
        return t[self.brow * per:(self.brow + 1) * per]

    def _local_placements(self, spec, row_dim):
        """This rank's rows over the batch axes, ``spec``'s model dim."""
        return tuple(
            (self._shard(row_dim) if row_dim is not None else self._rep())
            if n in self.dp_dims else p
            for n, p in zip(self.mesh.mesh_dim_names,
                            SP.placements(spec, self.mesh)))

    def to_mesh(self, t, spec, row_dim):
        """A model-axis DTensor of this rank's rows → a DTensor over the
        whole mesh in ``spec``'s layout."""
        from torch.distributed.tensor import DTensor
        mp = (_model_placement(spec, self.mesh),)
        local = t.redistribute(t.device_mesh, mp).to_local()
        g = DTensor.from_local(local, self.mesh,
                               self._local_placements(spec, row_dim),
                               run_check=False)
        return g.redistribute(self.mesh, SP.placements(spec, self.mesh))

    def from_mesh(self, t, spec, row_dim):
        """The inverse of `to_mesh`."""
        g = t.redistribute(self.mesh, self._local_placements(spec, row_dim))
        return _on_model_mesh(g, spec, self.mesh)

    def cache_to_mesh(self, cache):
        from torch.distributed.tensor import DTensor

        def one(names, t):
            if not isinstance(t, DTensor):   # made from plain tensors
                t = DTensor.from_local(t, self.mesh[SP.MP], (self._rep(),),
                                       run_check=False)
            return self.to_mesh(t, *self._leaf(names, t))
        return SP.spec_tree_map(one, cache)

    def cache_from_mesh(self, cache):
        return SP.spec_tree_map(
            lambda names, t: self.from_mesh(t, *self._leaf(names, t)), cache)

    def _leaf(self, names, t):
        spec, row = _spec_at(self.cspecs, names), _spec_at(self.row_dims,
                                                           names)
        if row is None and names[-1] == "pos" and t.dim() == 1 and self.b_ok:
            row = 0   # a per-row position (the LSTM's) whose spec is ()
        return spec, row


def make_prefill_step(model: Model, mesh, mesh_cfg: MeshConfig, pspecs,
                      shape: InputShape, *, max_len: Optional[int] = None):
    """``step(params, batch) → (logits, cache)``: params in ``pspecs``'
    layout, the batch global (plain tensors alike on every rank, or
    DTensors); the logits (B, Vpad) over ``(batch axes or None,
    "model")``, the cache in the `specs.cache_specs` layout, with
    ``max_len`` slots (default: the prompt's, as the reference's) so that
    a decode step of ``seq_len = max_len`` can take it."""
    lay = _Layout(model, mesh, mesh_cfg, shape)

    def step(params, batch):
        with host_routed_collectives(mesh), _implicit():
            pw = _serving_view(params, pspecs, mesh, model)
            dev = tree_leaves(strip_compute(pw))[0].to_local().device
            local = {k: lay.rows(v).to(dev) for k, v in batch.items()
                     if k != "labels"}
            logits, cache = model.prefill(pw, local, max_len=max_len)
            return (lay.to_mesh(logits, lay.logits_spec,
                                0 if lay.b_ok else None),
                    lay.cache_to_mesh(cache))

    return step


def make_decode_step(model: Model, mesh, mesh_cfg: MeshConfig, pspecs,
                     shape: InputShape):
    """``step(params, tokens, cache) → (logits, cache)``: one token per row
    against a cache in the `specs.cache_specs` layout of ``shape`` (as
    `make_prefill_step` returns it). The model writes the new K and V into
    the cache's own storage, as the unsharded ``decode_step`` does (the
    reference donates the cache)."""
    lay = _Layout(model, mesh, mesh_cfg, shape)

    def step(params, tokens, cache):
        with host_routed_collectives(mesh), _implicit():
            pw = _serving_view(params, pspecs, mesh, model)
            dev = tree_leaves(strip_compute(pw))[0].to_local().device
            local = lay.cache_from_mesh(cache)
            logits, new = model.decode_step(pw, lay.rows(tokens).to(dev),
                                            local)
            return (lay.to_mesh(logits, lay.logits_spec,
                                0 if lay.b_ok else None),
                    lay.cache_to_mesh(new))

    return step
