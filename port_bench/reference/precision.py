"""Operand precisions of the references' products.

``float32`` is the reference itself. ``float8`` is the control, the next
precision below the configurations' stated bfloat16: each operand scaled
by its absolute maximum to the e4m3 range (448), rounded to float8 e4m3
and scaled back, as a per-tensor-scaled fp8 product takes its inputs. Sums are
float32 in every case. The rounding passes gradients straight through, so
a control can train.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "float8")
_E4M3_MAX = 448.0


def _round(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp(min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def cast(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` in float32 with its values rounded to ``prec`` (gradient passed
    straight through)."""
    x = x.float()
    if prec == "float32":
        return x
    if prec not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{prec!r}")
    return x + (_round(x) - x).detach()


@contextlib.contextmanager
def exact_matmul():
    """float32 products as float32 (TF32 off) inside the block; the former
    settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
