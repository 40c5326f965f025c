"""The production step's layouts (`repro_torch.sharding.specs`) against the
reference's (`repro.sharding.specs`), leaf for leaf: ``param_specs`` and
``serving_param_specs`` for every assigned architecture and the paper's
CIFG-LSTM, ``cache_specs`` at decode_32k and long_500k (the dry run's
``arch_for_shape``), ``batch_specs`` at every input shape, on the
single-pod (16 × 16), multi-pod (2 × 16 × 16) and a (2, 2) mesh. The
reference's ``PartitionSpec``s are compared as tuples; the trees as nested
dicts keyed by path. The shape stand-ins are the reference's
``eval_shape`` trees and the port's meta tensors. Also: `placements`,
`shard_hint`, the input shapes and `arch_for_shape`.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import MULTI_POD as J_MULTI
from repro.configs import SINGLE_POD as J_SINGLE
from repro.configs import MeshConfig as JMeshConfig
from repro.configs import get_config as jget
from repro.launch.dryrun import arch_for_shape as j_arch_for_shape
from repro.models import build as jbuild
from repro.sharding import specs as JSP
from repro_torch.configs import (INPUT_SHAPES, MULTI_POD, SINGLE_POD,
                                 MeshConfig, get_config)
from repro_torch.launch import steps as ST
from repro_torch.launch.dryrun import arch_for_shape
from repro_torch.models import build
from repro_torch.models.layers import shard_hint
from repro_torch.sharding import specs as SP

ARCHS = list(ASSIGNED_ARCHS) + ["gboard-cifg-lstm"]
MESHES = {"single": (J_SINGLE, SINGLE_POD),
          "multi": (J_MULTI, MULTI_POD),
          "2x2": (JMeshConfig((2, 2), ("data", "model")),
                  MeshConfig((2, 2), ("data", "model")))}


def _ref_tree(tree):
    """A reference spec tree → nested dicts of plain tuples."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.PartitionSpec))[0]:
        node = out
        names = [str(k.key) for k in path]
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = tuple(spec)
    return out


def _port_tree(tree):
    return {k: (_port_tree(v) if isinstance(v, dict) else tuple(v))
            for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch):
    jm = jbuild(jget(arch))
    jshape = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    model = build(get_config(arch))
    pshape = ST.params_shape(model)
    for mesh, (jmc, pmc) in MESHES.items():
        assert _port_tree(SP.param_specs(pshape, model.cfg, pmc)) == \
            _ref_tree(JSP.param_specs(jshape, jm.cfg, jmc)), mesh
        assert _port_tree(SP.serving_param_specs(pshape, model.cfg, pmc)) \
            == _ref_tree(JSP.serving_param_specs(jshape, jm.cfg, jmc)), mesh


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, shape_name):
    shape, jshape_ = INPUT_SHAPES[shape_name], J_SHAPES[shape_name]
    jcfg = j_arch_for_shape(jget(arch), jshape_)
    jm = jbuild(jcfg)
    jcache = jax.eval_shape(lambda: jm.init_cache(jshape_.global_batch,
                                                  jshape_.seq_len))
    model = build(arch_for_shape(get_config(arch), shape))
    pcache = ST.cache_shape(model, shape)
    assert jax.tree_util.tree_map(lambda l: tuple(l.shape), jcache) == \
        {k: tuple(v.shape) for k, v in pcache.items()}
    for mesh, (jmc, pmc) in MESHES.items():
        assert _port_tree(SP.cache_specs(pcache, model.cfg, shape, pmc)) \
            == _ref_tree(JSP.cache_specs(jcache, jcfg, jshape_, jmc)), mesh


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small",
                                  "chameleon-34b"])
def test_batch_specs_and_input_shapes_equal_the_reference(arch):
    for name, shape in INPUT_SHAPES.items():
        js = J_SHAPES[name]
        assert (shape.name, shape.seq_len, shape.global_batch, shape.kind) \
            == (js.name, js.seq_len, js.global_batch, js.kind)
        for mesh, (jmc, pmc) in MESHES.items():
            assert _port_tree(SP.batch_specs(get_config(arch), shape, pmc)) \
                == _ref_tree(JSP.batch_specs(jget(arch), js, jmc)), mesh
        got = arch_for_shape(get_config(arch), shape)
        assert got.attn_window == j_arch_for_shape(jget(arch),
                                                   js).attn_window
    cfg = get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        inputs = ST.input_specs(cfg, shape)
        from repro.launch.steps import input_specs as j_inputs
        want = j_inputs(jget(arch), J_SHAPES[name])
        assert {k: tuple(v.shape) for k, v in inputs.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in inputs.values())


def test_placements_and_the_shard_hint_off_a_mesh(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh, one_rank
    with one_rank(device="cpu"):
        mesh = make_production_mesh(multi_pod=True, shape=(1, 1, 1),
                                    device_type="cpu")
        assert SP.placements(SP.Spec(("pod", "data"), "model"), mesh) == \
            (Shard(0), Shard(0), Shard(1))
        assert SP.placements(SP.Spec(None, "data"), mesh) == \
            (Replicate(), Shard(1), Replicate())
        with pytest.raises(ValueError):
            SP.placements(SP.Spec(("data", "pod")), mesh)
        with pytest.raises(ValueError):
            SP.placements(SP.Spec("expert"), mesh)
    x = torch.ones(2, 3)
    assert shard_hint(x, ("pod", "data"), "model") is x   # no mesh: no-op
    assert SP.drop_fsdp(SP.Spec(("pod", "data"), "model")) == \
        SP.Spec("pod", "model")
    assert SP.drop_fsdp(SP.Spec("data", None)) == SP.Spec(None, None)


def test_params_shape_allocates_nothing():
    model = build(get_config("chameleon-34b"))
    shapes = ST.params_shape(model)
    leaves = jax.tree_util.tree_leaves(
        jax.eval_shape(jbuild(jget("chameleon-34b")).init,
                       jax.random.PRNGKey(0)))
    from repro_torch.utils.pytree import tree_leaves
    got = tree_leaves(shapes)
    assert all(t.device.type == "meta" for t in got)
    assert [tuple(t.shape) for t in got] == [tuple(l.shape) for l in leaves]
    assert sum(t.numel() for t in got) == sum(int(np.prod(l.shape))
                                              for l in leaves)
    opt = ST.opt_state_shape(shapes)
    assert all(t.dtype == torch.float32 for t in tree_leaves(opt.momentum))
