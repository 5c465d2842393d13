"""The readers of the program's own spans (``repro_torch.obs``): on the tiny
cells on the CPU, on a made-up ring and trace whose clocks differ, and on a
program without the span recorder (an older tree), where each returns None.
"""
import sys
import threading

import pytest

from perfbench import tiny
from perfbench.lib import harness, program_spans, spec
from perfbench.lib.trace import Trace

NEW = ("adam_ms.train", "adam_ms.ckpt", "moe_dispatch_ms.train", "save_d2h_s", "save_cache_s",
       "durable_s", "idle_recon_pct")
MOE = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")


def traced_run(cell, monkeypatch, **kw):
    """A traced tiny run of ``cell``: its result line and the readers' ctx."""
    seen = {}
    real = harness.per_layer

    def spy(metrics, ctx):
        seen["ctx"] = ctx
        return real(metrics, ctx)

    monkeypatch.setattr(harness, "per_layer", spy)
    return tiny.run(cell, trace=True, **kw), seen["ctx"]


def _value(line, name):
    return line["metrics"][name]["value"]


def _durable(ctx):
    """``durable_s`` is read by its reader, not from the line: it is no
    entry of ``BENCHMARK.json`` (the traced run's profiler stop sets it)."""
    return spec.metric_reader("durable_s").read(ctx)


def _last_id() -> int:
    from repro_torch import obs
    return max((r.id for r in obs.spans()), default=0)


def _own(since: int, name: str):
    from repro_torch import obs
    return [r for r in obs.spans() if r.id > since and r.name == name]


def test_checkpoint_cell_reads_the_save_and_its_durability(monkeypatch):
    line, ctx = traced_run("mamba2-train-ckpt", monkeypatch)
    d2h, cache = _value(line, "save_d2h_s"), _value(line, "save_cache_s")
    durable, stall = _durable(ctx), _value(line, "save_stall_s")
    assert all(isinstance(v, float) and v > 0 for v in (d2h, cache, durable))
    assert d2h + cache <= stall
    assert "durable_s" not in line["metrics"]
    run = program_spans.run_spans(ctx)
    # every traced span of the main thread found its mark in the trace
    assert len(run.anchors) >= 4 + 2 * 3 and run.named("tce.save")


def test_two_runs_in_one_process_each_read_their_own_spans(monkeypatch):
    for seed in (tiny.SEED, tiny.SEED + 1):
        since = _last_id()
        line, ctx = traced_run("mamba2-train-ckpt", monkeypatch, seed=seed)
        snap, = _own(since, "tce.snapshot")
        save, = _own(since, "tce.save")
        commit, = [c for c in _own(since, "tce.commit") if c.attrs["step"] == save.attrs["step"]]
        assert _value(line, "save_d2h_s") == snap.seconds
        put, = [r for r in _own(since, "tce.cache_put") if r.parent == save.id]
        assert _value(line, "save_cache_s") == put.seconds
        assert _durable(ctx) == (commit.t1 - save.t1) * 1e-9


def test_moe_cell_trace_holds_the_moe_spans(monkeypatch):
    line, ctx = traced_run("olmoe-train", monkeypatch)
    trace = ctx["trace"]
    tid = trace.main_tid("bench_step")
    layers = tiny.OLMOE["n_layers"]
    for name in MOE + ("train.forward", "train.backward", "train.adam"):
        mine = [s for s in trace.spans[name] if s[2] == tid]
        # one a layer (or a step) in each traced step
        want = ctx["profiled"] * (layers if name in MOE else 1)
        assert len(mine) == want, name
    run = program_spans.run_spans(ctx)
    assert len(run.anchors) == ctx["profiled"] * (3 + 4 * layers)
    # the CPU build has no device kernels: the device readers have nothing
    assert "adam_ms.train" not in line["metrics"]


def test_without_the_span_recorder_every_new_reader_reads_none(monkeypatch):
    """As on a tree that has no ``repro_torch.obs``: its trace holds no
    program span, and the import fails."""
    import repro_torch
    from repro_torch import obs

    monkeypatch.setattr(obs, "_profiling", lambda: False)
    for cell in ("olmoe-train", "mamba2-train-ckpt"):
        line, ctx = traced_run(cell, monkeypatch)
        with monkeypatch.context() as m:
            m.delattr(repro_torch, "obs")
            m.setitem(sys.modules, "repro_torch.obs", None)
            assert program_spans.ring() is None
            for name in NEW:
                assert spec.metric_reader(name).read(ctx) is None, name
            # the harness's reading of the run, as on that tree
            wanted = spec.cell_metrics(spec.benchmark(), cell)["per_layer"]
            assert not set(NEW) & set(harness.per_layer(wanted, ctx))
        assert "idle_recon_pct" not in line["metrics"] and "adam_ms.train" not in line["metrics"]


# --------------------------------------------------------------------------- #
# a made-up run: the trace's clock is the ring's (in us) plus 5000
# --------------------------------------------------------------------------- #
OFFSET = 5000.0


def _rec(i, name, t0_us, t1_us, traced, thread=None, parent=None, **attrs):
    from repro_torch.obs import Record
    return Record(i, parent, name, thread or threading.get_ident(), int(t0_us * 1e3),
                  int(t1_us * 1e3), attrs, traced)


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def made_up(monkeypatch, recon_t0=40):
    """``recon_t0``: where the reconciler's pass opens, on the ring's clock
    (us); the save runs over [0, 5]."""
    other = threading.get_ident() + 1
    recs = [
        # an earlier run: traced, then an untraced span, then its commit
        _rec(1, "tce.save", -1000, -900, True, step=3),
        _rec(2, "train.adam", -800, -700, True),
        _rec(3, "train.adam", -500, -400, False),
        _rec(4, "tce.commit", -400, -300, False, thread=other, step=3),
        # this run
        _rec(10, "tce.save", 0, 5, True, step=3),
        _rec(11, "tce.snapshot", 1, 2, True, parent=10),
        _rec(12, "tce.cache_put", 2, 4, True, parent=10),
        _rec(13, "tce.cache_put", 2, 3, False, thread=other, parent=12),
        # its end read 300 us late (a wait for the interpreter lock)
        _rec(14, "train.adam", 10, 360, True),
        _rec(15, "tce.reconcile", recon_t0, 95, False, thread=other),
        _rec(16, "tce.commit", 100, 105, False, thread=other, parent=15, step=3),
        _rec(17, "train.adam", 120, 130, False),
    ]
    events = [
        _x("user_annotation", "bench_step", OFFSET, 100),
        _x("user_annotation", "tce.save", OFFSET + 0, 5),
        _x("user_annotation", "tce.snapshot", OFFSET + 1, 1),
        _x("user_annotation", "tce.cache_put", OFFSET + 2, 2),
        _x("user_annotation", "train.adam", OFFSET + 10, 50),
        _x("cuda_runtime", "cudaLaunchKernel", OFFSET + 20, 1, corr=7),
        _x("kernel", "adam_kernel", OFFSET + 30, 20, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", OFFSET + 65, 1, corr=8),
        _x("kernel", "other_kernel", OFFSET + 70, 20, corr=8),
    ]
    monkeypatch.setattr(program_spans, "ring", lambda: recs)
    return {"trace": Trace(events), "segment": (OFFSET, OFFSET + 100), "profiled": 1}


@pytest.mark.parametrize("recon_t0", [40, 3], ids=["after_the_save", "inside_the_save"])
def test_made_up_run_on_one_clock(monkeypatch, recon_t0):
    ctx = made_up(monkeypatch, recon_t0)
    run = program_spans.run_spans(ctx)
    assert [r.id for r in run.records] == [10, 11, 12, 13, 14, 15, 16, 17]
    assert run.offset_us == pytest.approx(OFFSET) and run.spread_us == pytest.approx(0, abs=1e-6)
    assert run.on_trace(run.anchors[0]) == pytest.approx((OFFSET, OFFSET + 5))
    read = {name: spec.metric_reader(name).read(ctx) for name in NEW}
    assert read["adam_ms.train"] == read["adam_ms.ckpt"] == pytest.approx(0.020)
    assert read["moe_dispatch_ms.train"] is None
    assert read["save_d2h_s"] == pytest.approx(1e-6)
    assert read["save_cache_s"] == pytest.approx(2e-6)
    assert read["durable_s"] == pytest.approx(100e-6)
    # the device busy over [30, 50] and [70, 90]. A pass open over [40, 95]:
    # idle 25 of the segment's 100. One that opens at 3, inside the save
    # ([0, 5]), counts from the save's end: [5, 95] holds 50 idle (52 with
    # the save's own [3, 5])
    want = 25.0 if recon_t0 >= 5 else 50.0
    assert read["idle_recon_pct"] == pytest.approx(want)


def test_made_up_run_whose_trace_lacks_a_traced_span_reads_none(monkeypatch):
    """Without the anchors the reconciler's spans have no place on the
    trace's clock; the save's readers read the ring alone and still read."""
    ctx = made_up(monkeypatch)
    ctx["trace"].spans.pop("tce.snapshot")
    assert program_spans.run_spans(ctx) is None
    assert spec.metric_reader("idle_recon_pct").read(ctx) is None
    for name in ("save_d2h_s", "save_cache_s", "durable_s"):
        assert spec.metric_reader(name).read(ctx) is not None, name
