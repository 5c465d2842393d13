"""Device ms per traced training step of the kernels launched inside the
program's ``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans (the
scatter MoE's router, capacity dispatch and weighted combine,
``models/moe.py``). Forward only: their backward runs under
``train.backward``, outside these spans; the expert products
(``moe.experts``) are not counted."""
from perfbench.lib.program_spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("moe.route", "moe.dispatch", "moe.combine"))
