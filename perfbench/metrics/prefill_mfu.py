"""Model operations of the window's prefill waves over the window's
seconds, as a share of the bf16 peak, in %."""
from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, "prefill")
