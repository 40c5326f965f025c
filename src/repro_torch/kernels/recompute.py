"""The gradient of a forward-only kernel: its plain version, recomputed.

The flash attention and SSD scan kernels compute forward passes only, as
the TPU kernels they port do. The reference trains through the plain
functions those kernels compute (``L.attention`` and ``ssd_chunked``), and
XLA differentiates them. `RecomputeGrad` gives a kernel launch the same
gradient: its forward launches the kernel and saves only the inputs; its
backward runs the plain PyTorch version again, under grad, on detached
copies of the inputs that need a gradient, and returns ``torch.autograd.grad``
of that recomputation. The backward launches no kernel, so a wrapper's
launch counter counts forward launches only.

The recomputation holds what the plain version holds (for attention the
whole score matrix of one call), one call at a time; under the models'
per-layer remat that is one layer's. A batch that folds a chunk of
clients (`by_client`) is recomputed a client at a time: the plain
version's batched products see the batch count of a one-client call, so a
client's gradient does not depend on how many clients share the launch.
"""
from __future__ import annotations

import torch

from repro_torch.utils.spans import span


class RecomputeGrad(torch.autograd.Function):
    """``RecomputeGrad.apply(launch, plain, *inputs)``: ``launch(*inputs)``
    forward (a tensor or a tuple of tensors), the gradient of
    ``plain(*inputs)`` backward. An output's incoming gradient may be
    ``None`` (the output did not reach the loss); it is left out of the
    recomputation's ``autograd.grad``."""

    @staticmethod
    def forward(ctx, launch, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.set_materialize_grads(False)
        return launch(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        with span("recompute.backward"):
            need = ctx.needs_input_grad[2:]
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            wrt = [t for t, n in zip(leaves, need) if n]
            pairs = []
            if wrt:
                with torch.enable_grad():
                    outs = ctx.plain(*leaves)
                if not isinstance(outs, tuple):
                    outs = (outs,)
                pairs = [(o, g) for o, g in zip(outs, grads)
                         if g is not None]
            if not pairs:
                return (None, None) + (None,) * len(need)
            got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                           [g for _, g in pairs],
                                           allow_unused=True))
            return (None, None) + tuple(next(got) if n else None
                                        for n in need)


def by_client(plain, clients: int):
    """``plain`` of each client's rows of a folded batch: every input's
    leading axis cut into ``clients`` equal groups, ``plain`` called on each
    group, the outputs (a tensor or a tuple of tensors) concatenated on
    their leading axis. One client too goes through the cut and the
    concatenation, so that its gradients have the layout they have in a
    wider chunk."""

    def run(*inputs):
        outs = [plain(*group) for group in
                zip(*(t.chunk(clients) for t in inputs))]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)
    return run
