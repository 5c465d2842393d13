"""Share of the traced segment in which nothing ran on the device while a
``tce.reconcile`` span (a reconciler pass with work: digest, persist with
fsync, ring backup, commit) was open on the reconciler's thread, after the
run's ``tce.save`` had returned, in %: the part of ``idle_pct.ckpt`` that the
reconciler's work beside the steps may explain. A pass opens as soon as the
first rank's put has landed, inside the save's stall, which
``save_cache_s`` owns; that stretch is left out. The reconciler's spans come
from the program's ring, put on the trace's clock by the anchors
(``perfbench/lib/program_spans.py``)."""
from perfbench.lib.program_spans import run_spans
from perfbench.lib.trace import _clip, union


def read(ctx):
    trace, seg = ctx.get("trace"), ctx.get("segment")
    run = run_spans(ctx)
    if run is None or seg is None or not trace.busy_us(*seg):
        return None
    saves = [run.on_trace(r)[1] for r in run.named("tce.save")]
    start = max([seg[0], *saves])
    recon = union(_clip([run.on_trace(r) for r in run.named("tce.reconcile")], start, seg[1]))
    if not recon:
        return None
    idle = sum(b - a - trace.busy_us(a, b) for a, b in recon)
    return 100.0 * idle / (seg[1] - seg[0])
