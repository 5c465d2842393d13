"""Model operations of the window's training steps (forward and backward)
over the window's seconds, as a share of the bf16 peak, in %. Serves
``train_mfu`` and ``train_mfu.ckpt``; in the checkpoint cell the save and
the reconciler's work beside the steps are in the window's seconds."""
from perfbench.lib.readers import mfu


def read(ctx):
    return mfu(ctx, "train")
