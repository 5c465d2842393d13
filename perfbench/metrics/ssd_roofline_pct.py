"""The SSD scan's share of its roofline in the traced waves: the least
time of its calls (each the larger of its operations at the bf16 peak and
its bytes at the memory peak, from the call's shapes) over the device time
of the kernels launched inside the benchmark's ``ssd_scan`` spans, in %."""
from perfbench.counts.flops import ssd_bound_s


def read(ctx):
    seg, calls = ctx.get("segment"), ctx.get("ssd_calls")
    if seg is None or not calls or ctx.get("trace") is None:
        return None
    device_us = sum(b - a for a, b, *_ in ctx["trace"].kernels_under("ssd_scan", *seg))
    if device_us <= 0:
        return None
    return 100.0 * sum(ssd_bound_s(*c) for c in calls) / (device_us * 1e-6)
