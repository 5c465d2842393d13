"""Host seconds from the end of the ring's last ``tce.save`` to the end of
the reconciler's ``tce.commit`` of the same step (its manifest written once
every rank has persisted): how long after the stall the save is durable.
Read from the ring alone.

Not an entry of ``BENCHMARK.json``: per-layer metrics are read only in the
traced run, whose profiler, stopped after the traced steps, holds the
interpreter lock for seconds and with it the reconciler's thread whenever
the pass outlasts those steps. Its number there is set by the profiler's
stop, not by the reconciler."""
from perfbench.lib.program_spans import last_save


def read(ctx):
    got = last_save()
    if got is None:
        return None
    save, after = got
    ends = [c.t1 for c in after
            if c.name == "tce.commit" and c.attrs.get("step") == save.attrs.get("step")]
    return (min(ends) - save.t1) * 1e-9 if ends else None
