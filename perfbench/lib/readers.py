"""What the per-layer readers share: each takes the run's ``ctx`` (the
driver's counts and host-clock readings, the trace and its traced segment)
and returns a number, or None where the run has nothing for it to read."""
from __future__ import annotations

from typing import Optional

from perfbench.lib.trace import kernel_kind


def _segment(ctx: dict):
    if ctx.get("trace") is None or ctx.get("segment") is None:
        return None
    return ctx["segment"]


def idle_pct(ctx: dict) -> Optional[float]:
    """100 x (1 - time with an operation on the device / the traced span)."""
    seg = _segment(ctx)
    if seg is None:
        return None
    busy = ctx["trace"].busy_us(*seg)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / (seg[1] - seg[0]))


def elementwise_ms(ctx: dict) -> Optional[float]:
    """Device milliseconds per traced step (or wave) of the kernels whose
    names class them as elementwise or copy."""
    seg = _segment(ctx)
    if seg is None or not ctx.get("profiled"):
        return None
    ks = ctx["trace"].kernels_in(*seg)
    if not ks:
        return None
    us = sum(b - a for a, b, name, *_ in ks if kernel_kind(name) == "elementwise / copy")
    return us * 1e-3 / ctx["profiled"]


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """Model operations of the window's work over its seconds, as a share
    of the chip's bf16 peak."""
    if ctx.get("kind") != kind or not ctx.get("mfu_seconds"):
        return None
    return 100.0 * ctx["mfu_flops"] / ctx["mfu_seconds"] / ctx["peaks"]["bf16_flops_s"]
