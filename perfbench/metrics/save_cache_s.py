"""Host seconds of the ``tce.cache_put`` span directly under the ring's last
``tce.save`` (sharding and every rank's put into its cache arena, the ranks
in parallel; not the per-rank spans under it): the rest of the save's stall
but its wait on the reconciler (``tce.quiesce``). Read from the ring alone."""
from perfbench.lib.program_spans import save_child_seconds


def read(ctx):
    return save_child_seconds("tce.cache_put")
