"""Host seconds of the ``tce.snapshot`` span of the ring's last ``tce.save``:
the TCE save's copy of the training state from the device to the host
(``flatten_pytree``), a part of the save's stall. Read from the ring alone."""
from perfbench.lib.program_spans import save_child_seconds


def read(ctx):
    return save_child_seconds("tce.snapshot")
