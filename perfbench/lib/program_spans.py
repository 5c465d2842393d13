"""The program's own spans (``repro_torch.obs``) beside the device trace of a
``--trace 1`` run, for the readers of ``program_span`` metrics.

The ring holds every span of the process, on the host's
``time.perf_counter_ns`` clock; the trace is on the profiler's. The anchors
are the spans that the thread reading them (the one that drove the run)
recorded while the profiler ran: each also stands in the trace, a
``record_function`` of the same name on the trace's main thread, paired in
order of start. A span reads the ring's clock before the profiler stamps its
start and after it stamps its end, so each pair bounds the offset (trace
clock - ring clock): at most (trace start - ring start), at least (trace end
- ring end). The offset is the middle of the tightest bounds over all pairs,
and ``spread_us`` their distance. A single bound may be far off: a thread
that waits for the interpreter lock between the stamp and its own read (the
reconciler's thread holds it at times) loosens that pair's bound by the wait,
up to a millisecond on an H100 host, and leaves the tightest bounds alone.

The ring may hold an earlier run's spans (the CPU tests run several cells in
one process): this run's traced spans are the last unbroken stretch of this
thread's spans that were traced, and the run's spans are every thread's
spans that end at or after the first of them. Only ``idle_recon_pct`` needs
the trace's clock; the readers of host seconds take the ring's last
``tce.save`` and what hangs off it (:func:`last_save`), with no trace. A run
with no traced save or step, or a program with no ``obs`` module (an older
tree), gives None, never an error.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

Interval = Tuple[float, float]


def ring() -> Optional[list]:
    """Every span the process recorded, or None where the program has no
    span recorder."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    return obs.spans()


@dataclass
class RunSpans:
    records: list            # the run's spans, on the ring's clock (ns)
    anchors: list            # the traced ones of the reading thread, by start
    marks: List[Interval]    # each anchor's interval in the trace (us)

    @property
    def upper_us(self) -> float:
        return min(a - r.t0 * 1e-3 for (a, _b), r in zip(self.marks, self.anchors))

    @property
    def lower_us(self) -> float:
        return max(b - r.t1 * 1e-3 for (_a, b), r in zip(self.marks, self.anchors))

    @property
    def offset_us(self) -> float:
        return (self.upper_us + self.lower_us) / 2

    @property
    def spread_us(self) -> float:
        """How far apart the tightest bounds lie (below 0: the pairs
        disagree, as two clocks that drift apart would make them)."""
        return self.upper_us - self.lower_us

    def named(self, name: str) -> list:
        return [r for r in self.records if r.name == name]

    def on_trace(self, rec) -> Interval:
        """A span's interval on the trace's clock (us)."""
        return rec.t0 * 1e-3 + self.offset_us, rec.t1 * 1e-3 + self.offset_us


def _order(rec_or_span) -> tuple:
    a, b = rec_or_span
    return a, -b


def run_spans(ctx: dict) -> Optional[RunSpans]:
    """The run's spans and the clock's offset, or None."""
    trace, recs = ctx.get("trace"), ring()
    if trace is None or not recs:
        return None
    me = threading.get_ident()
    mine = sorted((r for r in recs if r.thread == me), key=lambda r: _order((r.t0, r.t1)))
    last = max((i for i, r in enumerate(mine) if r.traced), default=None)
    if last is None:
        return None
    first = last
    while first > 0 and mine[first - 1].traced:
        first -= 1
    anchors = mine[first:last + 1]
    tid = trace.main_tid("bench_step") or trace.main_tid("bench_wave")
    names = {r.name for r in anchors}
    marks = sorted(((a, b, name) for name in names for a, b, t in trace.spans.get(name, [])
                    if t == tid), key=lambda m: _order(m[:2]))
    if len(marks) != len(anchors) or any(m[2] != r.name for m, r in zip(marks, anchors)):
        return None
    start = anchors[0].t0
    return RunSpans([r for r in recs if r.t1 >= start], anchors, [m[:2] for m in marks])


def device_ms_per_step(ctx: dict, names: Iterable[str]) -> Optional[float]:
    """Device ms per traced step of the kernels launched inside the program's
    spans ``names`` within the traced segment (``Trace.kernels_under``)."""
    trace, seg = ctx.get("trace"), ctx.get("segment")
    if trace is None or seg is None or not ctx.get("profiled"):
        return None
    names = [n for n in names if trace.spans.get(n)]
    if not names or not trace.kernels_in(*seg):
        return None
    us = sum(b - a for n in names for a, b, *_ in trace.kernels_under(n, *seg))
    return us * 1e-3 / ctx["profiled"]


def last_save() -> Optional[Tuple[object, list]]:
    """The ring's last ``tce.save`` and every span recorded after it opened
    (its children, the reconciler's pass over it), or None."""
    recs = ring()
    saves = [r for r in recs or () if r.name == "tce.save"]
    if not saves:
        return None
    save = max(saves, key=lambda r: r.id)
    return save, [r for r in recs if r.id > save.id]


def save_child_seconds(name: str) -> Optional[float]:
    """Host seconds of the last save's direct children ``name``, summed."""
    got = last_save()
    if got is None:
        return None
    save, after = got
    kids = [r for r in after if r.name == name and r.parent == save.id]
    return sum(r.seconds for r in kids) if kids else None
