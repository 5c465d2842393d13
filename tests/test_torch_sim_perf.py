"""The port's mirror of ``tests/test_sim_perf.py``: each of its tests run on
``repro_torch``, plus three replay presets' reports against the
reference's. The reference's docstring:

Equivalence and determinism tests for the vectorized DES core.

The interactive-speed simulator core (batched fault sampling, array-backed
topology, batched event drain) must be a pure *performance* change: every
batched path has to reproduce the one-at-a-time seed semantics exactly.
These tests pin that equivalence at the queue level, at both engine levels
(soak and fleet), and for the counter-based RNG streams, plus the replay
preset registry and the ``BENCH_sim.json`` CI gate.
"""
import importlib.util
import json
import os

import pytest

from repro_torch.sim.clock import EventQueue, SimClock
from repro_torch.sim.faults import FaultEvent, FaultInjector, push_schedule


def _load_bench_gate():
    path = os.path.join(os.path.dirname(__file__), "..",
                        "scripts", "bench_gate.py")
    spec = importlib.util.spec_from_file_location("bench_gate_sim", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------------- #
# queue-level batching
# --------------------------------------------------------------------------- #
def test_pop_batch_matches_repeated_pops():
    def load(q):
        q.push(5.0, "a")
        q.push(1.0, "b")
        q.push(1.0, "c")     # same instant as "b": FIFO order must hold
        q.push(3.0, "d")
        q.push(1.0, "e")

    q1, q2 = EventQueue(), EventQueue()
    load(q1), load(q2)
    singles = []
    while q1:
        singles.append(q1.pop())
    batched = []
    while q2:
        t, payloads = q2.pop_batch()
        batched.extend((t, p) for p in payloads)
    assert batched == singles
    assert [p for _, p in batched[:3]] == ["b", "c", "e"]


def test_pop_batch_advances_clock_like_pop():
    q = EventQueue(SimClock())
    q.push(2.0, "x")
    q.push(2.0, "y")
    t, payloads = q.pop_batch(advance_clock=True)
    assert t == 2.0 and payloads == ["x", "y"]
    assert q.clock.seconds == 2.0


def test_push_batch_preserves_fifo_tie_break():
    items = [(4.0, "a"), (1.0, "b"), (4.0, "c"), (1.0, "d"), (2.0, "e")]
    q1 = EventQueue()
    for t, p in items:
        q1.push(t, p)
    q2 = EventQueue()
    assert q2.push_batch(items) == len(items)
    drain1 = [q1.pop() for _ in range(len(q1))]
    drain2 = [q2.pop() for _ in range(len(q2))]
    assert drain1 == drain2
    # same-t payloads come back in push order on both paths
    assert [p for t, p in drain1 if t == 1.0] == ["b", "d"]
    assert [p for t, p in drain1 if t == 4.0] == ["a", "c"]


def test_push_schedule_bulk_loads_through_push_batch():
    clock = SimClock()
    clock.advance(100.0)
    q = EventQueue(clock)
    evs = [FaultEvent(t=10.0, node="node0000", category="gpu_hw",
                      degrades_only=False),
           FaultEvent(t=5.0, node="node0001", category="network",
                      degrades_only=False)]
    assert push_schedule(q, evs) == 2
    t, ev = q.pop()
    assert t == 105.0 and ev.node == "node0001"   # offset by queue's now


# --------------------------------------------------------------------------- #
# engine-level: batched drain == one-at-a-time drain
# --------------------------------------------------------------------------- #
def test_soak_incident_coalescing_is_pure_batching(monkeypatch):
    """The soak engine's same-(t, domain) incident drain must not change
    the simulation — only how many handler invocations it takes."""
    from repro_torch.sim import soak as soak_mod
    from repro_torch.sim.soak import SoakConfig, run_soak

    cfg = dict(ideal_days=2.0, n_nodes=16, n_spares=2, mtbf_node_days=8.0,
               repair_hours=4.0, rack_mtbf_days=20.0, seed=3)
    batched = run_soak(SoakConfig(**cfg))
    monkeypatch.setattr(soak_mod, "COALESCE_INCIDENTS", False)
    single = run_soak(SoakConfig(**cfg))
    assert batched == single


def test_fleet_incident_grouping_is_pure_batching(monkeypatch):
    """Replacing the fleet engine's incident grouping with singletons must
    reproduce the identical report (grouping preserves queue order)."""
    from repro_torch.fleet import engine as engine_mod
    from repro_torch.fleet.engine import FleetConfig, run_fleet
    from repro_torch.fleet.scheduler import JobSpec

    cfg = FleetConfig(
        jobs=(JobSpec("a", 6, priority=2, min_nodes=3, ideal_hours=24.0),
              JobSpec("b", 6, priority=1, min_nodes=3, ideal_hours=24.0)),
        n_nodes=12, n_spares=2, mtbf_node_days=6.0, repair_hours=4.0,
        rack_mtbf_days=15.0, horizon_days=10.0)
    grouped = run_fleet(cfg, seed=5)
    monkeypatch.setattr(engine_mod, "group_domain_incidents",
                        lambda drained: [[d] for d in drained])
    singles = run_fleet(cfg, seed=5)
    assert grouped == singles


# --------------------------------------------------------------------------- #
# counter-based RNG streams
# --------------------------------------------------------------------------- #
def _sched_tuples(inj):
    return [(e.t, e.node, e.category, e.degrades_only)
            for e in inj.schedule()]


def test_schedule_is_deterministic_per_seed():
    a = _sched_tuples(FaultInjector(64, 10.0, horizon_days=30.0, seed=11))
    b = _sched_tuples(FaultInjector(64, 10.0, horizon_days=30.0, seed=11))
    c = _sched_tuples(FaultInjector(64, 10.0, horizon_days=30.0, seed=12))
    assert a == b
    assert a != c


def test_schedule_is_prefix_stable_in_n_nodes():
    """Growing the cluster never rewrites the existing nodes' streams —
    the per-node counter streams are independent of n_nodes."""
    small = _sched_tuples(FaultInjector(32, 12.0, horizon_days=25.0, seed=4))
    large = _sched_tuples(FaultInjector(96, 12.0, horizon_days=25.0, seed=4))
    keep = {f"node{i:04d}" for i in range(32)}
    assert [e for e in large if e[1] in keep] == small


def test_schedule_is_chunk_width_invariant():
    """The sampled timeline is a pure function of the counter streams: the
    internal batch width must never leak into the result."""
    ref = _sched_tuples(FaultInjector(80, 9.0, horizon_days=35.0, seed=2))
    for width in (4, 5, 9, 32, 128):
        inj = FaultInjector(80, 9.0, horizon_days=35.0, seed=2)
        inj._chunk_width = width
        assert _sched_tuples(inj) == ref, f"width {width} changed the stream"


def test_schedule_category_mix_tracks_weights():
    inj = FaultInjector(400, 5.0, horizon_days=60.0, seed=9)
    evs = inj.schedule()
    assert len(evs) > 2000
    freq = {}
    for e in evs:
        freq[e.category] = freq.get(e.category, 0) + 1
    for cat, w in zip(inj.cats, inj.w):
        got = freq.get(cat, 0) / len(evs)
        assert abs(got - w) < 0.03, f"{cat}: {got:.3f} vs weight {w:.3f}"


def test_schedule_times_are_sorted_and_inside_horizon():
    evs = FaultInjector(100, 8.0, horizon_days=20.0, seed=1).schedule()
    ts = [e.t for e in evs]
    assert ts == sorted(ts)
    assert all(0.0 < t < 20.0 * 86400.0 for t in ts)


# --------------------------------------------------------------------------- #
# replay presets
# --------------------------------------------------------------------------- #
def test_replay_registry_covers_both_mixes_at_three_scales():
    from repro_torch.sim.replay import REPLAY_PRESETS, SCALE_POINTS

    for mix in ("table1", "bytedance"):
        for scale, tag in (("64", "week"), ("1k", "month"), ("10k", "month")):
            assert f"{mix}_{scale}_{tag}" in REPLAY_PRESETS
    assert SCALE_POINTS["10k"][0] == 10240


def test_replay_week_preset_is_deterministic_and_json_safe():
    from repro_torch.sim.replay import run_replay

    a = run_replay("table1_64_week", seed=0)
    b = run_replay("table1_64_week", seed=0)
    assert a == b
    assert a["replay"] == "table1_64_week"
    assert a["mix"]["name"] == "table1"
    assert a["faults"]["injected"] > 0
    json.dumps(a)


def test_replay_planner_policy_override():
    from repro_torch.sim.replay import run_replay

    rep = run_replay("table1_64_week", seed=0, planner_policy="no_shrink")
    assert rep["planner_policy"] == "no_shrink"


@pytest.mark.slow
def test_replay_10k_month_is_interactive_scale():
    """The tentpole bar: the 10k-node, ~30-modelled-day fleet replay is an
    interactive run (the bench gate pins <= 60 s; allow slack here for
    slower CI hosts running the full suite in parallel)."""
    import time

    from repro_torch.sim.replay import run_replay

    t0 = time.perf_counter()
    rep = run_replay("table1_10k_month", seed=0)
    wall = time.perf_counter() - t0
    assert rep["faults"]["injected"] > 1000
    assert wall < 120.0, f"10k replay took {wall:.0f}s"


# --------------------------------------------------------------------------- #
# BENCH_sim gate
# --------------------------------------------------------------------------- #
def _sim_artifact():
    return {
        "bench": "sim", "seed": 0, "quick": False,
        "scale_points": {
            "1k": {"n_nodes": 1024, "horizon_days": 40.0, "n_events": 410,
                   "digest": "abcd", "replay": {
                       "preset": "table1_1k_month", "makespan_days": 30.0,
                       "utilization": 0.9, "faults_injected": 410,
                       "faults_hit_jobs": 100}},
        },
        "measured": {"walls": {}, "hot_loop": {},
                     "checks": {"hot_loop_speedup_20x_at_1k": True}},
    }


def test_gate_sim_passes_identical_artifacts():
    gate_any = _load_bench_gate().gate_any

    assert gate_any(_sim_artifact(), _sim_artifact()) == []


def test_gate_sim_fails_on_digest_drift():
    gate_any = _load_bench_gate().gate_any

    fresh = _sim_artifact()
    fresh["scale_points"]["1k"]["digest"] = "ffff"
    fails = gate_any(fresh, _sim_artifact())
    assert any("digest" in f for f in fails)


def test_gate_sim_fails_on_false_check_and_missing_point():
    gate_any = _load_bench_gate().gate_any

    fresh = _sim_artifact()
    fresh["measured"]["checks"]["hot_loop_speedup_20x_at_1k"] = False
    assert any("went false" in f for f in gate_any(fresh, _sim_artifact()))

    baseline = _sim_artifact()
    baseline["scale_points"]["10k"] = dict(
        baseline["scale_points"]["1k"], digest="eeee")
    fails = gate_any(_sim_artifact(), baseline)
    assert any("missing" in f for f in fails)


def test_gate_sim_tolerates_utilization_jitter_but_not_regression():
    gate_any = _load_bench_gate().gate_any

    fresh = _sim_artifact()
    fresh["scale_points"]["1k"]["replay"]["utilization"] = 0.88
    assert gate_any(fresh, _sim_artifact()) == []        # within 5 %
    fresh["scale_points"]["1k"]["replay"]["utilization"] = 0.80
    assert any("utilization" in f
               for f in gate_any(fresh, _sim_artifact()))


# --------------------------------------------------------------------------- #
# replay presets: the port's reports against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["table1_64_week", "bytedance_64_week",
                                  "table1_1k_month"])
def test_replay_preset_equals_the_reference(name):
    from repro.sim.replay import run_replay as ref_run_replay
    from repro_torch.report import strip_volatile
    from repro_torch.sim.replay import run_replay

    def canon(rep):
        return json.dumps(strip_volatile(rep), sort_keys=True)

    port = run_replay(name, seed=0)
    assert port["engine"] == "fleet"
    assert canon(port) == canon(ref_run_replay(name, seed=0))
