"""Device ms per traced training step of the kernels launched inside the
program's ``mla.project``, ``mla.attend`` and ``mla.out`` spans (multi-head
latent attention's products, kv norm and rope, its chunked attention, and
its output product, ``models/mla.py``). Forward only: their backward runs
under ``train.backward``, outside these spans."""
from perfbench.lib.program_spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("mla.project", "mla.attend", "mla.out"))
