"""Model operations of ``dsv2lite-train``'s window (forward and backward)
over the window's seconds, as a share of the bf16 peak, in %, counted by
``counts/mla_moe.py``. The run's ``mfu_flops`` is counted with
``counts/flops.py``, which has no term for MLA, shared experts or a dense
prefix; this reader takes the window's tokens back from it, over
``flops.train_flops_per_token`` of the cell's own ``port`` section and
sequence, and counts them again."""
from perfbench.counts import flops, mla_moe
from perfbench.lib import spec

CELL = "dsv2lite-train"


def read(ctx):
    if ctx.get("kind") != "train" or not ctx.get("mfu_seconds"):
        return None
    bench = spec.benchmark()
    cell = spec.cell(bench, CELL)
    m = spec.config(bench, cell["config"])["port"]
    seq = spec.traffic(cell["traffic"])["seq"]
    tokens = ctx["mfu_flops"] / flops.train_flops_per_token(m, seq)
    return (100.0 * mla_moe.train_flops_per_token(m, seq) * tokens / ctx["mfu_seconds"]
            / ctx["peaks"]["bf16_flops_s"])
