"""Parameters: carrying them across from the JAX package and back, and the
compute-dtype copies of the weights.

The reference casts its float32 weights to the compute dtype inside every
call. The port makes those copies once per parameter set — at init, at load
and at each hot-swap, never per call — and keeps them under
``params["compute"]``. Which copies a model computes with is its own
decision: each model module has a ``compute_copies(params, dtype)``, which
its ``build`` hands on as ``Model.compute_copies``, and every caller passes
it to `with_compute_copies` / `from_jax_params`. `matrix_copies` here is the
common form (``ssm``, ``hybrid``): a mirror of the tree with every matrix in
the compute dtype and the vectors as they are. At zamba2-2.7b's width the
float32 weights are 9.4 GB: casting them on every decode step would read
9.4 GB and write 4.7 GB per token.

The values are those the reference computes with. The copies are for
serving: a training parameter set carries none (`strip_compute`), and the
model then casts its weights inside the autograd graph on every call.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import torch_dtype
from repro_torch.utils.pytree import tree_leaves

COMPUTE = "compute"

# (params without "compute", compute dtype) -> the copies
CopiesFn = Callable[[Dict[str, Any], torch.dtype], Dict]


def matrix_copies(tree, cd: torch.dtype, *, stacked: Sequence[str] = (),
                  _in_stack: bool = False):
    """A mirror of ``tree`` with every matrix (a leaf of two or more dims
    per layer: projections, conv weights, embedding) in ``cd`` and the
    vectors (norm scales, biases, ``A_log``, ``dt_bias``, ``D``) as they
    are. Under a key in ``stacked`` the first axis stacks the layers and
    does not count. In float32 the mirror holds the parameters themselves."""
    if isinstance(tree, dict):
        return {k: matrix_copies(v, cd, stacked=stacked,
                                 _in_stack=_in_stack or k in stacked)
                for k, v in tree.items()}
    return tree.to(cd).contiguous() if tree.dim() - _in_stack >= 2 else tree


def _copies_dtype(copies: Dict) -> torch.dtype:
    """The dtype a set of copies was made for: the one narrower than
    float32 among its leaves, or float32 when there is none."""
    narrow = {t.dtype for t in tree_leaves(copies)
              if t.is_floating_point() and t.dtype != torch.float32}
    if len(narrow) > 1:
        raise ValueError(f"compute copies mix dtypes {sorted(map(str, narrow))}")
    return narrow.pop() if narrow else torch.float32


def with_compute_copies(params: Dict[str, Any], compute_dtype,
                        make_copies: CopiesFn) -> Dict:
    """``params`` with ``params["compute"] = make_copies(params, dtype)``
    (returned unchanged when the copies are already there for that
    dtype). ``make_copies`` is the model's ``compute_copies``."""
    cd = torch_dtype(compute_dtype)
    cur = params.get(COMPUTE)
    if cur is not None and _copies_dtype(cur) == cd:
        return params
    out = strip_compute(params)
    out[COMPUTE] = make_copies(out, cd)
    return out


def param_device(params: Dict[str, Any]) -> torch.device:
    """The device a parameter set lives on (that of its first leaf)."""
    return tree_leaves(strip_compute(params))[0].device


def strip_compute(params: Dict[str, Any]) -> Dict:
    """``params`` without the compute copies: what training updates,
    differentiates, clips, sums and checkpoints. Copies made from a
    parameter set go stale as soon as it is updated, and they are cut from
    autograd, so no training path may carry them."""
    return {k: v for k, v in params.items() if k != COMPUTE}


def from_jax_params(tree, make_copies: CopiesFn, device=None,
                    compute_dtype="bfloat16") -> Dict:
    """The reference's parameter tree of any family (nested dicts of numpy
    or array leaves, in its layout — for the CIFG-LSTM ``embed.tok``
    (Vpad, d), ``w_x`` (d, 3H), ``w_h`` (H, 3H), ``b_gates`` (3H,),
    ``w_proj`` (H, d); for Mamba-2 and the hybrid the stacked
    ``(n_layers, …)`` layer leaves) → the port's tensors on ``device``, with
    the compute-dtype copies that ``make_copies`` (the model's
    ``compute_copies``) makes."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.kind not in "iub":   # float weights (f32, bf16) → f32
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dev)

    return with_compute_copies(conv(tree), compute_dtype, make_copies)


def to_numpy(params: Dict[str, Any]) -> Dict:
    """The port's parameters → a nested dict of numpy arrays in the
    reference's layout (the compute copies are dropped)."""
    return {k: (to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in params.items() if k != COMPUTE}
