"""What the per-layer metric files read (each ``metrics/<name>.py`` binds
one of these as its ``read``). A reader takes the run's context — the
window's `trace.TraceData` (``trace``), its host seconds (``window_s``),
the units of work it finished (``rounds`` or ``chunks``), the model FLOPs
it needed (``flops``), the launches the cell's driver predicts by kernel and
shape (``work``), the peak of device memory (``peak_bytes``) — and returns
a number, or None when there is nothing to read: a share of a roofline or
of a peak is never reported as 0."""
from __future__ import annotations

from typing import Optional

from port_bench.harness import manifest
from port_bench.harness.peaks import MFU_PEAK


def _trace(ctx):
    return ctx.get("trace")


def launches_per_round(ctx) -> Optional[float]:
    """CUDA kernels a round, from the trace."""
    t = _trace(ctx)
    if t is None or not ctx.get("rounds") or not t.launches:
        return None
    return t.launches / ctx["rounds"]


def clip_sum_ms_per_round(ctx) -> Optional[float]:
    """Device milliseconds a round of the clip's sums of squares and the
    clipped accumulation (``dp_sumsq``, ``dp_clip_accumulate``)."""
    t = _trace(ctx)
    if t is None or not ctx.get("rounds"):
        return None
    n, s = t.time_of(*manifest.kernel_counts("dp_sumsq").KERNEL_NAMES,
                     *manifest.kernel_counts("dp_clip_accumulate")
                     .KERNEL_NAMES)
    return 1e3 * s / ctx["rounds"] if n else None


def device_ms_per_chunk(ctx) -> Optional[float]:
    """Device milliseconds (every kernel and copy, their union) a chunk of
    ``chunk`` sequences."""
    t = _trace(ctx)
    if t is None or not ctx.get("chunks") or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / ctx["chunks"]


def roofline(ctx, kernel: str) -> Optional[float]:
    """The kernel's launches in the window against their bound: the sum of
    each launch's bound (its shape from the cell driver's ``work``) over the
    kernels' device time in the trace, in %. None when the trace holds
    none of its launches, or not the number the work predicts."""
    t, work = _trace(ctx), ctx.get("work", {}).get(kernel)
    if t is None or not work:
        return None
    mod = manifest.kernel_counts(kernel)
    n, s = t.time_of(*mod.KERNEL_NAMES)
    calls = sum(c for _, c in work)
    if n == 0 or s <= 0 or n != calls * mod.KERNELS_PER_CALL:
        return None
    bound = sum(mod.bound(**shape)[0] * c for shape, c in work)
    return 100.0 * bound / s


def mfu(ctx) -> Optional[float]:
    """The model FLOPs the window needed over its length at the bf16 dense
    peak, in %."""
    if not ctx.get("flops") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"] * MFU_PEAK)


def device_idle(ctx) -> Optional[float]:
    """The traced window's share with no kernel, copy or set on the card,
    in %."""
    t = _trace(ctx)
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_mem(ctx) -> Optional[float]:
    """The peak of allocated device memory over the run, GiB."""
    b = ctx.get("peak_bytes")
    return b / 2 ** 30 if b else None
