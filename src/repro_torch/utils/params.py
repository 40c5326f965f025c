"""Parameters: carrying them across from the JAX package and back, and the
compute-dtype copies of the weights.

The reference casts its float32 weights to the compute dtype inside every
call. The port makes those copies once per parameter set — at init, at load
and at each hot-swap, never per tick — and keeps them under
``params["compute"]``:

* ``w_h`` in the compute dtype, the operand of the cell kernel;
* ``tok`` (and ``head``), ``w_x`` and ``w_proj`` rounded to the compute dtype
  and held in float32, the operands of the float32 products
  (`repro_torch.utils.numerics`).

The values are those the reference computes with. The copies are for
serving: a training parameter set carries none (`strip_compute`), and the
model then casts its weights inside the autograd graph on every call.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.utils.device import resolve_device
from repro_torch.utils.numerics import round_to, torch_dtype

COMPUTE = "compute"


def with_compute_copies(params: Dict[str, Any], compute_dtype) -> Dict:
    """``params`` with ``params["compute"]`` made for ``compute_dtype``
    (returned unchanged when it is already there for that dtype)."""
    cd = torch_dtype(compute_dtype)
    cur = params.get(COMPUTE)
    if cur is not None and cur["w_h"].dtype == cd:
        return params
    out = {k: v for k, v in params.items() if k != COMPUTE}
    copies = {"tok": round_to(params["embed"]["tok"], cd),
              "w_x": round_to(params["w_x"], cd),
              "w_h": params["w_h"].to(cd).contiguous(),
              "w_proj": round_to(params["w_proj"], cd)}
    if "head" in params["embed"]:
        copies["head"] = round_to(params["embed"]["head"], cd)
    out[COMPUTE] = copies
    return out


def compute_weights(params: Dict[str, Any], compute_dtype) -> Dict:
    return with_compute_copies(params, compute_dtype)[COMPUTE]


def strip_compute(params: Dict[str, Any]) -> Dict:
    """``params`` without the compute copies: what training updates,
    differentiates, clips, sums and checkpoints. Copies made from a
    parameter set go stale as soon as it is updated, and they are cut from
    autograd, so no training path may carry them."""
    return {k: v for k, v in params.items() if k != COMPUTE}


def from_jax_params(tree, device=None, compute_dtype="bfloat16") -> Dict:
    """The reference's parameter dict (numpy or array leaves: ``embed.tok``
    (Vpad, d), ``w_x`` (d, 3H), ``w_h`` (H, 3H), ``b_gates`` (3H,),
    ``w_proj`` (H, d)) → the port's tensors on ``device``, with the
    compute-dtype copies made."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.kind not in "iub":   # float weights (f32, bf16) → f32
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a)).to(dev)

    return with_compute_copies(conv(tree), compute_dtype)


def to_numpy(params: Dict[str, Any]) -> Dict:
    """The port's parameters → a nested dict of numpy arrays in the
    reference's layout (the compute copies are dropped)."""
    return {k: (to_numpy(v) if isinstance(v, dict)
                else v.detach().cpu().numpy())
            for k, v in params.items() if k != COMPUTE}
