"""Device ms per traced training step of the kernels launched inside the
program's ``train.adam`` spans (AdamW with its global-norm clip,
``train/optimizer.py``). Serves ``adam_ms.train`` and ``adam_ms.ckpt``."""
from perfbench.lib.program_spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("train.adam",))
