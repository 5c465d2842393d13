"""Share of the traced segment (the traced steps or waves; in the checkpoint
cell, the save and the steps after it) in which nothing ran on the device
(kernels, copies and sets as a union of intervals), in %. Serves every
``idle_pct.<cell kind>`` metric."""
from perfbench.lib.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
