"""The port's span recorder (``repro_torch.obs``) and the spans the TCE
engine and its reconciler record."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine  # noqa: E402


def _since() -> int:
    return max((r.id for r in obs.spans()), default=0)


def _mine(since: int, thread=None):
    return [r for r in obs.spans() if r.id > since
            and (thread is None or r.thread == thread)]


def test_parents_on_one_thread_and_an_explicit_parent_on_another():
    since = _since()
    with obs.span("outer", k=1) as outer:
        with obs.span("inner") as inner:
            pass
        box = {}

        def work():
            with obs.span("pooled", parent=outer) as s:
                box["id"] = s.id
                with obs.span("pooled_child"):
                    pass

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
    recs = {r.name: r for r in _mine(since)}
    assert recs["outer"].parent is None and recs["outer"].attrs == {"k": 1}
    assert recs["inner"].parent == outer.id == recs["pooled"].parent
    assert recs["pooled_child"].parent == box["id"] == recs["pooled"].id
    assert recs["pooled"].thread != recs["outer"].thread == threading.get_ident()
    assert recs["outer"].t0 <= recs["inner"].t0 <= recs["inner"].t1 <= recs["outer"].t1
    assert outer.seconds == recs["outer"].seconds > 0 and inner.id == recs["inner"].id


def test_add_sums_into_the_innermost_open_span_and_on_demand_opens_once():
    since = _since()
    obs.add(lost=1)                         # no span open: nothing
    with obs.span("a"):
        with obs.span("b"):
            obs.add(n=2)
            obs.add(n=3, m=1.5)
        obs.add(n=1)
    with obs.on_demand("idle") as working:
        pass
    with obs.on_demand("busy", x=1) as working:
        first = working()
        assert working() is first
        with obs.span("child"):
            pass
    recs = {r.name: r for r in _mine(since, threading.get_ident())}
    assert recs["b"].attrs == {"n": 5, "m": 1.5} and recs["a"].attrs == {"n": 1}
    assert "idle" not in recs and recs["busy"].attrs == {"x": 1}
    assert recs["child"].parent == recs["busy"].id


def test_the_ring_is_bounded():
    for i in range(obs.RING_SIZE + 10):
        with obs.span("filler", i=i):
            pass
    recs = obs.spans()
    assert len(recs) == obs.RING_SIZE
    assert recs[-1].attrs == {"i": obs.RING_SIZE + 9}
    assert recs[0].attrs == {"i": 10}


def test_profiled_spans_stand_in_the_chrome_trace_and_unprofiled_do_not(tmp_path):
    since = _since()
    with obs.span("unprofiled.block"):
        torch.ones(8).sum()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with obs.span("profiled.outer"):
            with obs.span("profiled.inner"):
                torch.ones(8).sum()
    finally:
        prof.stop()
    with obs.span("unprofiled.after"):
        pass
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"profiled.outer", "profiled.inner"} <= names
    assert not {"unprofiled.block", "unprofiled.after"} & names
    traced = {r.name: r.traced for r in _mine(since, threading.get_ident())}
    assert traced == {"unprofiled.block": False, "profiled.inner": True,
                      "profiled.outer": True, "unprofiled.after": False}


def _engine(tmp_path, n_nodes=2):
    return TCEngine(TCEConfig(n_nodes=n_nodes, async_persist=False),
                    DiskStore(str(tmp_path / "store"), device="cpu"))


def _state():
    rng = np.random.default_rng(0)
    return {f"layer{i}/w": rng.standard_normal((64, 8)).astype(np.float32) for i in range(4)}


def test_a_save_records_its_phases_and_the_handle_reads_them(tmp_path):
    eng = _engine(tmp_path)
    since = _since()
    handle = eng.save(5, {k: torch.from_numpy(v) for k, v in _state().items()})
    eng.close()
    recs = _mine(since)
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    save = by["tce.save"][0]
    assert save.attrs == {"step": 5}
    snap, = by["tce.snapshot"]
    assert snap.parent == save.id and snap.attrs["bytes"] == handle.nbytes
    assert handle.snapshot_s == snap.seconds
    puts = by["tce.cache_put"]
    top, = [r for r in puts if r.parent == save.id]
    assert handle.cache_wall_s == top.seconds
    ranks = sorted((r.attrs["rank"], r.parent) for r in puts if r is not top)
    assert ranks == [(0, top.id), (1, top.id)]
    assert top.attrs["bytes_staged"] == handle.bytes_staged
    # the pass the synchronous save ran, under it
    rec, = by["tce.reconcile"]
    assert rec.parent == save.id
    assert {r.name for r in recs if r.parent == rec.id} == {
        "tce.digest", "tce.persist", "tce.backup", "tce.commit"}
    persist = by["tce.persist"]
    assert sorted(r.attrs["rank"] for r in persist) == [0, 1]
    assert all(r.attrs["fsync_s"] > 0 and r.attrs["bytes"] > 0 for r in persist)
    # each of the 4 leaves has a shard on each of the 2 ranks
    assert sum(r.attrs["leaves_written"] for r in persist) == 4 * 2
    backup = by["tce.backup"]
    assert sum(r.attrs["bytes"] for r in backup) == handle.nbytes
    assert by["tce.commit"][0].attrs == {"step": 5, "ranks": 2}


def test_a_reconcile_pass_with_no_work_records_no_span(tmp_path):
    eng = _engine(tmp_path)
    eng.save(1, _state())
    since = _since()
    passes = eng.reconciler.passes
    eng.reconciler.reconcile_once()
    eng.reconciler.reconcile_once()
    eng.close()
    assert eng.reconciler.passes == passes + 2
    assert not [r for r in _mine(since) if r.name.startswith("tce.")]
