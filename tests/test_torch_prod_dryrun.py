"""The port's dry run (`repro_torch.launch.dryrun`): steps traced on a fake
process group under ``FakeTensorMode``, no device touched.

* At a fake world of 4 ranks ((2, 2) over data × model) on reduced
  configs, each kind of step (train, prefill, decode) issues collectives
  over its model axis and counts FLOPs.
* granite-3-2b × train_4k on the 16 × 16 fake mesh writes its record, and
  its per-rank argument bytes are the sum of the shard sizes the
  reference's own specs imply (params, momentum and nu in
  ``param_specs``, the int32 count, tokens and labels in ``batch_specs``).
"""
import json
import math

import jax
import numpy as np
import pytest

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import SINGLE_POD as J_SINGLE
from repro.configs import get_config as jget
from repro.launch import steps as JST
from repro.models import build as jbuild
from repro.sharding import specs as JSP
from repro_torch.configs import get_config
from repro_torch.launch import dryrun


def _ref_shard_bytes(tree, specs, sizes) -> int:
    total = 0
    for leaf, spec in zip(jax.tree_util.tree_leaves(tree),
                          jax.tree_util.tree_leaves(
                              specs, is_leaf=lambda x: isinstance(
                                  x, jax.sharding.PartitionSpec))):
        n = 1
        for d, dim in enumerate(leaf.shape):
            e = spec[d] if d < len(spec) else None
            axes = e if isinstance(e, tuple) else (() if e is None else (e,))
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "train_4k"),
                                        ("olmoe-1b-7b", "prefill_32k"),
                                        ("granite-3-2b", "decode_32k")])
def test_dryrun_at_a_fake_world_of_four_counts_collectives(arch, shape):
    rec = dryrun.dryrun_one(arch, shape, False, save=False, verbose=False,
                            cfg=get_config(arch).reduced(),
                            mesh_shape=(2, 2))
    assert rec["n_devices"] == 4 and rec["mesh"] == "2x2"
    coll = rec["collectives"]
    assert coll["total_bytes"] > 0
    assert coll["all_reduce"]["count"] > 0 or \
        coll["all_gather"]["count"] > 0
    assert rec["flops"] > 0 and rec["arg_bytes"] > 0
    if shape == "train_4k":
        # the round sum is reduce-scattered into the FSDP layout
        assert coll["reduce_scatter"]["count"] > 0
        assert rec["micro_scale"] == 256 // 2


def test_dryrun_granite_train_4k_16x16_arg_bytes_are_the_reference_specs(
        tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    rec = dryrun.dryrun_one("granite-3-2b", "train_4k", False, verbose=False)
    saved = json.loads(
        (tmp_path / "granite-3-2b__train_4k__16x16.json").read_text())
    assert saved == rec
    assert rec["n_devices"] == 256

    jm = jbuild(jget("granite-3-2b"))
    shape = J_SHAPES["train_4k"]
    params = JST.params_shape(jm)
    pspecs = JSP.param_specs(params, jm.cfg, J_SINGLE)
    sizes = dict(zip(J_SINGLE.axes, J_SINGLE.shape))
    inputs = JST.input_specs(jm.cfg, shape)
    want = (3 * _ref_shard_bytes(params, pspecs, sizes)   # f32 p, m, nu
            + 4                                            # the count
            + _ref_shard_bytes(inputs, JSP.batch_specs(jm.cfg, shape,
                                                       J_SINGLE), sizes))
    assert rec["arg_bytes"] == want
    assert rec["n_params"] == sum(int(np.prod(l.shape)) for l in
                                  jax.tree_util.tree_leaves(params))
    assert rec["flops"] > 0
    for kind in ("all_reduce", "all_gather", "reduce_scatter"):
        assert rec["collectives"][kind]["count"] > 0, kind
