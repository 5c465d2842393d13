"""The port's mirror of ``tests/test_sim.py``: each of its tests run on
``repro_torch`` (every scenario and substrate on ``device="cpu"``), plus the
closed-loop case of ``tests/test_recovery.py``. The reference's docstring:

Unified simulation substrate: one clock, one topology, one fault model.

Covers the clock-unification invariants (identity of the SimClock object
across TOL/TEE/TCE), the kernel primitives (event queue, topology failure
domains, correlated/cascading injectors), the unified Table-I taxonomy, and
the named-scenario engine (determinism + full-loop execution).
"""
import json

import numpy as np
import pytest

from repro_torch.sim import (EventQueue, FaultEvent, FaultInjector, SimClock,
                             Topology, cascade_events, correlated_domain_failure)
from repro_torch.sim.scenarios import SCENARIOS, build_substrate, run_scenario
from repro_torch.sim.topology import NodeState


# --------------------------------------------------------------------------- #
# clock + event queue
# --------------------------------------------------------------------------- #
def test_clock_is_monotonic():
    c = SimClock()
    c.advance(5.0)
    c.advance_to(3.0)          # in the past -> no-op
    assert c.seconds == 5.0
    with pytest.raises(ValueError):
        c.advance(-1.0)


def test_event_queue_orders_and_advances_clock():
    c = SimClock()
    q = EventQueue(c)
    q.push(10.0, "b")
    q.push(5.0, "a")
    q.push(10.0, "c")          # FIFO among equal times
    t, p = q.pop(advance_clock=True)
    assert (t, p) == (5.0, "a") and c.seconds == 5.0
    assert [p for _, p in q.pop_due(10.0)] == ["b", "c"]
    assert q.peek_time() == float("inf")


def test_pop_due_can_ride_the_clock_forward():
    # popping a future window with advance_clock=True must never leave the
    # clock behind an event it handed out (the soak-loop monotonicity fix)
    c = SimClock()
    q = EventQueue(c)
    q.push(30.0, "x")
    q.push(70.0, "y")
    out = q.pop_due(100.0, advance_clock=True)
    assert [p for _, p in out] == ["x", "y"]
    assert c.seconds == 100.0            # landed exactly on the cutoff
    # and without the flag the old behaviour (clock untouched) is preserved
    c2 = SimClock()
    q2 = EventQueue(c2)
    q2.push(30.0, "x")
    q2.pop_due(100.0)
    assert c2.seconds == 0.0


def test_run_until_advances_clock_before_each_handler():
    c = SimClock()
    q = EventQueue(c)
    seen = []
    q.push(10.0, "a")
    q.push(20.0, "b")

    def handler(t, payload):
        # the clock is already at (or past) the event when the handler runs
        assert c.seconds >= t
        seen.append(payload)
        if payload == "a":
            q.push_after(5.0, "cascade")   # lands at 15.0, inside the window

    n = q.run_until(50.0, handler)
    assert seen == ["a", "cascade", "b"]
    assert n == 3 and c.seconds == 50.0


# --------------------------------------------------------------------------- #
# one clock / one topology identity (the tentpole invariant)
# --------------------------------------------------------------------------- #
def test_one_clock_shared_by_all_subsystems(tmp_path):
    sub = build_substrate(n_nodes=4, n_spares=2, store_root=str(tmp_path),
                          device="cpu")
    try:
        # identity, not equality: the orchestrator, engine, fabric, store,
        # reconciler and topology all tick on the *same* SimClock object
        assert sub.operator.clock is sub.clock
        assert sub.tce.clock is sub.clock
        assert sub.fabric.clock is sub.clock
        assert sub.store.clock is sub.clock
        assert sub.topology.clock is sub.clock
        assert sub.tce.reconciler.clock is sub.clock
        assert sub.clock_identity_ok()
        # one topology too: fabric up/down state is derived, not duplicated
        assert sub.fabric.topology is sub.topology
        assert sub.operator.cluster is sub.topology
    finally:
        sub.close()


def test_fabric_derives_down_state_from_topology(tmp_path):
    sub = build_substrate(n_nodes=4, n_spares=0, store_root=str(tmp_path),
                          device="cpu")
    try:
        assert not sub.fabric.is_down(1)
        sub.tce.node_failed(1)     # goes through fabric -> topology
        node = sub.topology.node_of_rank(1)
        assert sub.topology.nodes[node].state == NodeState.FAILED
        assert sub.fabric.is_down(1)
        sub.tce.node_recovered(1)
        assert sub.topology.nodes[node].state == NodeState.HEALTHY
        assert not sub.fabric.is_down(1)
    finally:
        sub.close()


def test_scenario_timeline_is_single_and_monotonic():
    rep = run_scenario("single_node_crash", device="cpu")
    assert rep["one_clock"] is True
    assert rep["clock_s"] > 0
    # every recovery phase was charged to the same clock the fabric ticks on
    assert rep["clock_s"] >= rep["recovery"]["total_downtime_s"]


# --------------------------------------------------------------------------- #
# unified fault taxonomy
# --------------------------------------------------------------------------- #
def test_fault_taxonomy_is_single_source_of_truth():
    from repro_torch.core.tee import FAULT_CATEGORIES as tee_cats
    from repro_torch.core.tee.traces import FAULT_CATEGORIES as trace_cats
    from repro_torch.core.tol.cluster import FAULT_CATEGORIES as tol_cats
    from repro_torch.sim.faults import FAULT_CATEGORIES as kernel_cats

    assert tee_cats is kernel_cats
    assert trace_cats is kernel_cats
    assert tol_cats is kernel_cats


def test_trace_generated_from_injected_fault():
    from repro_torch.core.tee import TraceGenerator

    gen = TraceGenerator(n_ranks=8, seed=3)
    ev = FaultEvent(t=0.0, node="node0002", category="node_hw",
                    degrades_only=False)
    tr = gen.from_event(ev, bad_rank=2)
    assert tr.bad_ranks == (2,)
    assert tr.label == "node_hw"
    # the crash signature lands on exactly the injected rank
    assert (tr.metrics[2, tr.onset:, :] == 0).all()
    assert tr.metrics[3, tr.onset, 0] > 0


def test_degradation_fault_renders_as_straggler():
    from repro_torch.core.tee import TraceGenerator

    gen = TraceGenerator(n_ranks=4, seed=4)
    tr = gen.for_fault("network", 1, degrades_only=True)
    assert tr.bad_ranks == (1,)
    assert tr.label == "network"
    # straggler signature: the bad rank keeps running (not a flatline)
    assert tr.metrics[1, tr.onset:, 0].mean() > 0.1


# --------------------------------------------------------------------------- #
# topology: failure domains + correlated/cascading injection
# --------------------------------------------------------------------------- #
def test_topology_failure_domains():
    topo = Topology(n_nodes=8, n_spares=2, nodes_per_rack=4)
    assert topo.domain_of("node0000") == topo.domain_of("node0003") == "rack00"
    assert topo.domain_of("node0004") == "rack01"
    hit = topo.fail_domain("rack", "rack00", t=0.0, category="network")
    assert sorted(hit) == [f"node{i:04d}" for i in range(4)]
    assert sorted(topo.bad_assigned_nodes()) == sorted(hit)
    # spares live outside the active racks -> replacements avoid the domain
    new = topo.schedule_replacement(set(), avoid_domains={"rack00"})
    assert new is not None and topo.domain_of(new) != "rack00"


def test_domain_avoidance_is_soft():
    # default nodes_per_rack puts a small cluster (and its spares) all in
    # rack00: avoiding that domain must fall back to an in-domain spare
    # rather than failing the job while healthy spares exist
    topo = Topology(n_nodes=4, n_spares=4)     # everything in rack00
    new = topo.schedule_replacement(set(), avoid_domains={"rack00"})
    assert new is not None
    assert new in topo.assigned


def test_correlated_domain_failure_events():
    evs = correlated_domain_failure(["node0000", "node0001"], t=60.0,
                                    domain="switch00")
    assert len(evs) == 2
    assert all(e.domain == "switch00" and e.t == 60.0 for e in evs)


def test_cascade_events_land_in_recovery_window():
    prim = [FaultEvent(1000.0, "node0000", "node_hw", False)]
    nodes = [f"node{i:04d}" for i in range(8)]
    evs = cascade_events(prim, nodes, p_cascade=1.0,
                         recovery_window_s=300.0, seed=7)
    assert len(evs) == 2
    casc = [e for e in evs if e.cascade_of is not None][0]
    assert casc.node != "node0000"
    assert 1000.0 < casc.t <= 1300.0
    assert evs == sorted(evs, key=lambda e: e.t)


def test_cascade_events_drive_through_event_queue():
    # the time-triggered path: a cascading schedule pushed onto the shared
    # queue drains in timestamp order, with the cascade firing after its
    # primary and the clock never behind the event being handled
    from repro_torch.sim import push_schedule

    clock = SimClock()
    q = EventQueue(clock)
    prim = [FaultEvent(1000.0, "node0000", "node_hw", False)]
    sched = cascade_events(prim, [f"node{i:04d}" for i in range(4)],
                           p_cascade=1.0, recovery_window_s=300.0, seed=7)
    assert push_schedule(q, sched) == 2
    seen = []
    q.run_until(5000.0, lambda t, ev: seen.append((t, ev)))
    assert [ev.node for _, ev in seen][0] == "node0000"
    assert seen[1][1].cascade_of is not None
    assert seen[0][0] < seen[1][0] <= 1300.0
    assert clock.seconds == 5000.0


def test_correlated_domain_failure_through_event_queue():
    # a whole-domain outage pushed onto the queue takes out every member at
    # one timestamp when applied to the topology by the event loop
    from repro_torch.sim import push_schedule

    topo = Topology(n_nodes=4, n_spares=0, nodes_per_rack=2)
    q = EventQueue(topo.clock)
    members = topo.domain_members("rack", "rack00")
    push_schedule(q, correlated_domain_failure(members, t=60.0,
                                               domain="rack00"))
    q.run_until(120.0, lambda t, ev: topo.apply_fault(ev))
    assert sorted(topo.bad_assigned_nodes()) == sorted(members)
    for name in members:
        assert topo.nodes[name].state == NodeState.FAILED
    assert topo.clock.seconds == 120.0


def test_push_schedule_offsets_by_queue_now():
    from repro_torch.sim import push_schedule

    clock = SimClock()
    clock.advance(500.0)
    q = EventQueue(clock)
    push_schedule(q, [FaultEvent(10.0, "node0000", "node_hw", False)])
    assert q.peek_time() == 510.0    # schedule times are relative to now


def test_fault_injector_schedule_is_seeded():
    a = FaultInjector(16, seed=5).schedule()
    b = FaultInjector(16, seed=5).schedule()
    assert a == b
    assert all(e.category in {"storage", "network", "node_hw", "user_code",
                              "other"} for e in a)


def test_rank_binding_tracks_replacements():
    topo = Topology(n_nodes=2, n_spares=1)
    assert topo.node_of_rank(0) == "node0000"
    topo.evict("node0000", t=0.0)
    assert topo.is_rank_down(0)
    new = topo.schedule_replacement({"node0000"})
    topo.bind_rank(0, new)
    assert not topo.is_rank_down(0)
    assert topo.rank_of_node(new) == 0


# --------------------------------------------------------------------------- #
# scenario engine
# --------------------------------------------------------------------------- #
def test_registry_has_at_least_eight_scenarios():
    assert len(SCENARIOS) >= 8
    for s in SCENARIOS.values():
        assert s.description


def test_unknown_scenario_raises():
    with pytest.raises(KeyError):
        run_scenario("nope", device="cpu")


def test_single_node_crash_full_loop_and_deterministic():
    a = run_scenario("single_node_crash", device="cpu")
    b = run_scenario("single_node_crash", device="cpu")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["completed"] and a["steps_done"] == 30
    assert a["restarts"]["resched"] == 1
    assert a["lost_steps"] == 2            # fault@12, ckpt@10: bounded loss
    assert a["tee_verdicts"] >= 1          # TEE scored the injected fault
    assert a["final_w"] == 30.0            # training state survived recovery
    assert a["fsm_path"][-1] == "done"


def test_storage_stall_recovers_in_place():
    rep = run_scenario("storage_stall", device="cpu")
    assert rep["completed"]
    assert rep["restarts"]["inplace"] == 1
    assert rep["restarts"]["resched"] == 0
    assert "recover_inplace" in rep["fsm_path"]


def test_elastic_shrink_then_grow_round_trips_node_count():
    rep = run_scenario("elastic_shrink_then_grow", device="cpu")
    assert rep["completed"]
    assert rep["shrinks"] == 1
    assert rep["grows"] == 1
    assert rep["final_nodes"] == 4         # back to the original fleet size
    assert rep["final_w"] == 30.0


def test_save_racing_crash_bounded_staleness():
    rep = run_scenario("save_racing_crash", device="cpu")
    assert rep["completed"]
    # ckpt 10 was mid-pipeline when the crash hit: recovery point is ckpt 5,
    # lost work is bounded by 2 checkpoint intervals (paper's guarantee)
    assert rep["lost_steps"] == 6
    assert rep["final_w"] == 30.0


# --------------------------------------------------------------------------- #
# elastic restore: M != N nodes through the store_full reshard path
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n_from,n_to", [(4, 3), (2, 5)])
def test_restore_onto_different_node_count(tmp_path, n_from, n_to):
    from repro_torch.core.tce import DiskStore, TCEConfig, TCEngine

    rng = np.random.default_rng(0)
    state = {f"l{i}/w": rng.standard_normal((7, 5)).astype(np.float32)
             for i in range(4)}
    src = TCEngine(TCEConfig(n_nodes=n_from), DiskStore(str(tmp_path)))
    src.save(10, state, wait=True)
    src.close()

    dst = TCEngine(TCEConfig(n_nodes=n_to), DiskStore(str(tmp_path)))
    step, got = dst.restore()
    assert step == 10
    assert dst.stats["restore_sources"]["store_full"] == 1
    for k in state:
        np.testing.assert_array_equal(got[k], state[k])
    # the restored global state reshards cleanly onto the new ring
    dst.save(11, got, wait=True)
    step2, got2 = dst.restore(step=11)
    for k in state:
        np.testing.assert_array_equal(got2[k], state[k])
    dst.close()


# --------------------------------------------------------------------------- #
# from tests/test_recovery.py: the closed loop's decision log
# --------------------------------------------------------------------------- #
def test_scenario_report_carries_step_indexed_decisions():
    rep = run_scenario("elastic_shrink_then_grow", seed=0, device="cpu")
    log = rep["decisions"]["log"]
    assert rep["decisions"]["n"] == len(log) >= 2
    decisions = [e["decision"] for e in log]
    assert "shrink" in decisions and "regrow" in decisions
    # closed-loop entries are step-indexed (fault at step 10, grow at 20)
    assert all(0 <= e["t"] <= 30 for e in log)
