"""Arithmetic that the per-layer readers in ``metrics/`` share.  A reader that
finds nothing to read returns None, and the harness leaves its metric out."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from . import roofline, trace


def mfu(ctx, flops_per_unit: float) -> Optional[float]:
    """The window's share of the card's peak: the layer-product FLOPs its work
    units need over the traced window's length times the peak, in %."""
    seconds = ctx.hi - ctx.lo
    if ctx.units <= 0 or seconds <= 0:
        return None
    return 100.0 * flops_per_unit * ctx.units / (seconds * roofline.PEAK_FLOPS)


def kernel_roofline(ctx, time_pattern: str,
                    launches: Sequence[Tuple[str, tuple]]) -> Optional[float]:
    """A kernel's share of its roofline, in %: the bound of every launch seen
    in the window (``launches``: (name pattern, ``roofline.bounds`` arguments)
    per kind of launch) over the device time of the kernels matching
    ``time_pattern`` (the kernel and its helper passes)."""
    seconds = trace.kernel_seconds(ctx.events, time_pattern)
    if seconds <= 0:
        return None
    bound = sum(len(trace.kernels(ctx.events, pattern)) * roofline.bound_seconds(*roofline.bounds(*args))
                for pattern, args in launches)
    return 100.0 * bound / seconds


def device_idle(ctx) -> Optional[float]:
    """The share of the traced window in which no operation ran on the card, in %."""
    seconds = ctx.hi - ctx.lo
    if seconds <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(ctx.events) / seconds)


def net(ctx) -> tuple:
    """(widths, k0) of the cell's net, the leading ``roofline.bounds`` arguments."""
    return ctx.shapes["widths"], ctx.shapes["k0"]
