"""The port's mirror of ``tests/test_fleet.py``: each of its tests run on
``repro_torch`` (the operators on ``device="cpu"``), plus the fleet cases of
``tests/test_recovery.py``, the fleet capstone of ``tests/test_tee_stream.py``
and every fleet preset's report against the reference's. The reference's
docstring:

Fleet control plane: claim-based spare arbitration, gang scheduling,
priorities/preemption, contended NAS bandwidth, multi-job scenarios.

Covers the topology lease ledger under interleaved claimants (double-grant
impossibility, spare-pool exhaustion, anti-affinity fallback), the
SharedBandwidth processor-sharing arbiter, two concurrent per-job
TransomOperators on one shared topology, the fleet engine's acceptance
scenarios (rack outage hitting co-located jobs in one event; preemption
recovering the high-priority job faster on an identical fault timeline),
and the fleet bench gate.
"""
import json
import tempfile

import pytest

from repro_torch.core.tce.store import NASStore, SharedBandwidth
from repro_torch.fleet import (PRESETS, FleetConfig, FleetScheduler, JobSpec,
                               JobView, run_fleet, run_preset)
from repro_torch.report import strip_volatile
from repro_torch.sim.clock import SimClock
from repro_torch.sim.faults import FaultEvent
from repro_torch.sim.topology import DoubleGrantError, NodeState, Topology


# --------------------------------------------------------------------------- #
# claim ledger: interleaved claimants on one spare pool
# --------------------------------------------------------------------------- #
def test_interleaved_claimants_never_get_the_same_node():
    topo = Topology(8, n_spares=3, auto_assign=False)
    grants = []
    # jobs A and B alternate claims until the shared pool is dry
    for i in range(12):
        got = topo.claim_replacement(f"job{i % 2}", set())
        if got is None:
            break
        grants.append(got)
    assert len(grants) == len(set(grants)), "a node was double-granted"
    assert len(grants) == 11            # 8 active + 3 spares
    assert topo.claim_replacement("jobA", set()) is None
    assert topo.claim_replacement("jobB", set()) is None


def test_double_grant_raises():
    topo = Topology(4, n_spares=0, auto_assign=False)
    topo.claim_specific("node0000", "jobA")
    with pytest.raises(DoubleGrantError):
        topo.claim_specific("node0000", "jobB")
    # and release is claimant-checked
    with pytest.raises(DoubleGrantError):
        topo.release_node("node0000", "jobB")
    topo.release_node("node0000", "jobA")
    assert topo.claim_specific("node0000", "jobB") == "node0000"


def test_spare_pool_exhaustion_and_repair_reclaim_across_claimants():
    topo = Topology(2, n_spares=1, repair_hours=1.0, auto_assign=False)
    a = topo.claim_specific("node0000", "jobA")
    b = topo.claim_specific("node0001", "jobB")
    # A's node dies; A claims the only spare
    topo.nodes[a].state = NodeState.FAILED
    topo.evict(a, t=0.0)
    got_a = topo.claim_replacement("jobA", set())
    assert got_a == "spare0000"
    # B's node dies; the pool is dry -> denied
    topo.nodes[b].state = NodeState.FAILED
    topo.evict(b, t=0.0)
    assert topo.claim_replacement("jobB", set()) is None
    # A's cordoned machine repairs; B (a different claimant) may take it
    topo.repair_due(3700.0)
    assert topo.claim_replacement("jobB", set()) == a
    assert topo.owner_of(a) == "jobB"


def test_anti_affinity_fallback_under_interleaved_claimants():
    # 4 nodes in rack00/rack01, 2 spares in rack01; both jobs avoid rack00
    topo = Topology(4, n_spares=2, nodes_per_rack=2, auto_assign=False)
    avoid = {"rack00"}
    got = [topo.claim_replacement(f"job{i % 2}", set(), avoid_domains=avoid)
           for i in range(4)]
    # out-of-domain candidates (node0002/3 in rack01, spares in rack02)
    # are preferred for BOTH claimants...
    assert all(topo.domain_of(n) != "rack00" for n in got)
    # ...and once only rack00 remains, the soft preference falls back
    # rather than failing either claimant
    last = topo.claim_replacement("job0", set(), avoid_domains=avoid)
    assert last is not None and topo.domain_of(last) == "rack00"


def test_single_job_facade_keeps_leases_consistent():
    topo = Topology(4, n_spares=1)                 # auto_assign single job
    assert topo.n_leased() == 4
    topo.evict("node0001", t=0.0)
    assert topo.owner_of("node0001") is None
    got = topo.schedule_replacement(set())
    assert got == "spare0000"
    assert topo.owner_of(got) == Topology.DEFAULT_CLAIMANT
    assert set(topo.leases_of(Topology.DEFAULT_CLAIMANT)) == \
        set(topo.assigned)


# --------------------------------------------------------------------------- #
# gang scheduling + pending queue + donors
# --------------------------------------------------------------------------- #
def test_gang_scheduling_is_all_or_nothing_and_priority_ordered():
    topo = Topology(8, n_spares=0, auto_assign=False)
    sched = FleetScheduler(topo)
    assert sched.submit(JobSpec("big", 6)) is not None
    # 2 free nodes left: a 4-node job must NOT be partially admitted
    assert sched.submit(JobSpec("later", 4, priority=1)) is None
    assert topo.n_leased() == 6
    assert [s.name for s in sched.pending] == ["later"]
    # capacity frees -> the pending job gets its whole gang
    sched.complete("big")
    admitted = sched.try_admit()
    assert [s.name for s in admitted] == ["later"]
    assert len(sched.views["later"].assigned) == 4


def test_find_donor_prefers_lowest_priority_elastic_job():
    topo = Topology(12, n_spares=0, auto_assign=False)
    sched = FleetScheduler(topo)
    specs = {s.name: s for s in (JobSpec("hi", 4, priority=10, min_nodes=4),
                                 JobSpec("mid", 4, priority=5, min_nodes=2),
                                 JobSpec("lo", 4, priority=1, min_nodes=2))}
    for s in specs.values():
        assert sched.submit(s) is not None
    donor = sched.find_donor(specs["hi"], specs, {"mid", "lo"})
    assert donor == "lo"
    node = sched.donate("lo", "hi")
    assert topo.owner_of(node) == "hi"
    assert len(sched.views["lo"].assigned) == 3
    assert len(sched.views["hi"].assigned) == 5
    # lo is now at 3 > min_nodes=2, still donatable; mid next only if lo dry
    sched.views["lo"].assigned, keep = \
        sched.views["lo"].assigned[:2], sched.views["lo"].assigned
    assert sched.find_donor(specs["hi"], specs, {"mid", "lo"}) == "mid"


# --------------------------------------------------------------------------- #
# shared NAS bandwidth (processor sharing)
# --------------------------------------------------------------------------- #
def test_shared_bandwidth_two_equal_flows_take_double():
    arb = SharedBandwidth(1e9)
    solo = SharedBandwidth(1e9).transfer(0.0, 4e9)
    arb.start(0.0, 4e9, "save")
    contended = arb.transfer(0.0, 4e9, "restore")
    assert solo == pytest.approx(4.0)
    assert contended == pytest.approx(8.0, rel=1e-6)


def test_shared_bandwidth_event_api_orders_completions():
    arb = SharedBandwidth(1e9)
    a = arb.start(0.0, 1e9, "short")
    b = arb.start(0.0, 4e9, "long")
    t1 = arb.next_completion()
    # short flow: 1e9 at a 0.5e9 share -> 2 s
    assert t1 == pytest.approx(2.0)
    done = arb.take_completed(t1)
    assert [f for _, f, _ in done] == [a]
    # the survivor gets the full pipe for its remaining 3e9 -> 3 s more
    assert arb.next_completion() == pytest.approx(5.0)
    done = arb.take_completed(10.0)
    assert [f for _, f, _ in done] == [b]
    assert arb.active() == 0


def test_shared_bandwidth_cancel_releases_share():
    arb = SharedBandwidth(1e9)
    a = arb.start(0.0, 4e9, "save")
    arb.start(0.0, 4e9, "restore")
    arb.cancel(a)
    assert arb.transfer(0.0, 0.0) >= 0.0          # no crash on empty-ish
    assert arb.next_completion() is None or arb.active() <= 1


def test_nas_store_slows_down_under_contention(tmp_path):
    import numpy as np
    from repro_torch.core.tce.sharding import ShardSpec

    shards = {"w": (ShardSpec("w", (64,), "float32", (0, 64), 0, 1),
                    np.zeros(64, np.float32))}
    # solo store: full bandwidth
    clock_a = SimClock()
    store_a = NASStore(str(tmp_path / "a"), bw_per_rank=1e6, clock=clock_a,
                       arbiter=SharedBandwidth(1e6))
    store_a.write_rank(0, 0, shards)
    solo_s = clock_a.seconds
    # contended store: another job's modelled flow shares the uplink
    clock_b = SimClock()
    arb = SharedBandwidth(1e6)
    arb.start(0.0, 10e6, "other_job:restore")
    store_b = NASStore(str(tmp_path / "b"), bw_per_rank=1e6, clock=clock_b,
                       arbiter=arb)
    store_b.write_rank(0, 0, shards)
    assert clock_b.seconds == pytest.approx(2 * solo_s, rel=1e-6)


# --------------------------------------------------------------------------- #
# two per-job TransomOperators on ONE shared topology
# --------------------------------------------------------------------------- #
def _mini_stack(view, clock, shared_store, n_nodes):
    from repro_torch.core.tce import TCEConfig, TCEngine
    from repro_torch.core.tce.transport import Fabric
    from repro_torch.core.tol import TransomOperator, TransomServer

    # co-located jobs write the same step keys into ONE shared store root:
    # per-job namespaces keep them collision-free
    store = shared_store.namespace(view.job_id)
    fabric = Fabric(clock=clock, topology=view)
    tce = TCEngine(TCEConfig(n_nodes=n_nodes), store, fabric=fabric,
                   clock=clock, topology=view)
    op = TransomOperator(TransomServer(), view, tce, None, clock=clock,
                         device="cpu")
    return op


def test_two_operators_share_topology_without_node_overlap(tmp_path):
    from repro_torch.core.tce import NASStore as _NAS
    from repro_torch.core.tol import JobConfig
    from repro_torch.core.tol.orchestrator import SimulatedFault

    clock = SimClock()
    topo = Topology(4, n_spares=1, clock=clock, auto_assign=False)
    sched = FleetScheduler(topo)
    va = sched.submit(JobSpec("jobA", 2))
    vb = sched.submit(JobSpec("jobB", 2))
    assert va is not None and vb is not None
    shared = _NAS(str(tmp_path), clock=clock)
    op_a = _mini_stack(va, clock, shared, 2)
    op_b = _mini_stack(vb, clock, shared, 2)
    assert op_a.job_id == "jobA" and op_b.job_id == "jobB"

    state = {"w": __import__("numpy").zeros(8, "float32")}
    step = lambda s, i: {"w": s["w"] + 1}  # noqa: E731

    def crash_a(at_step):
        fired = {"done": False}

        def hook(i):
            if i == at_step and not fired["done"]:
                fired["done"] = True
                node = op_a.launchers[1].node
                topo.nodes[node].state = NodeState.FAILED
                topo.nodes[node].fail_category = "node_hw"
                raise SimulatedFault("node_hw", 1)
        return hook

    cfg = JobConfig(total_steps=10, ckpt_every=5, n_sim_nodes=2)
    rep_a, _ = op_a.run_job(cfg, state, step, fault_hook=crash_a(6))
    rep_b, _ = op_b.run_job(cfg, state, step)
    assert rep_a.completed and rep_b.completed
    # jobA's replacement came from the shared pool under its own claim...
    assert rep_a.restarts_resched == 1
    # ...and at no point did the two jobs' node sets intersect
    assert not set(va.assigned) & set(vb.assigned)
    assert {topo.owner_of(n) for n in va.assigned} == {"jobA"}
    assert {topo.owner_of(n) for n in vb.assigned} == {"jobB"}
    # both jobs wrote the same step keys into one shared root, namespaced
    # apart — identical step sets, zero collisions
    op_a.tce.reconciler.quiesce(10)
    op_b.tce.reconciler.quiesce(10)
    assert sorted(p.name for p in tmp_path.iterdir() if p.is_dir()) == \
        ["ns_jobA", "ns_jobB"]
    assert op_a.tce.store.steps() == op_b.tce.store.steps() != []
    op_a.tce.close()
    op_b.tce.close()


# --------------------------------------------------------------------------- #
# fleet engine: acceptance scenarios
# --------------------------------------------------------------------------- #
def test_rack_outage_hits_both_colocated_jobs_in_same_event():
    rep = run_preset("two_jobs_rack_outage", seed=0)
    assert rep["both_jobs_hit_in_same_event"] is True
    hits = [e for e in rep["correlated_events"] if e["domain"] == "rack00"]
    assert len(hits) == 1
    assert hits[0]["jobs"] == ["jobA", "jobB"]
    # both jobs went down at the same instant and restored through the
    # (contended) store
    for j in ("jobA", "jobB"):
        assert rep["jobs"][j]["restore_sources"] == {"store_full": 1}
        assert rep["jobs"][j]["faults"]["domain_hits"] == 4
    assert rep["fleet"]["nas"]["contended_flows"] >= 1
    assert rep["one_clock"] is True


def test_rack_outage_report_is_deterministic():
    a = run_preset("two_jobs_rack_outage", seed=0)
    b = run_preset("two_jobs_rack_outage", seed=0)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_priority_preemption_beats_no_preemption_on_same_timeline():
    rep = run_preset("priority_preemption", seed=0)
    assert rep["same_fault_timeline"] is True
    assert rep["preemption_recovers_faster"] is True
    hi = rep["hi_recovery_s"]
    # donation turns an hours-long repair wait into a minutes-long recovery
    assert hi["preemption"] < hi["no_preemption"] / 2
    assert rep["hi_end_to_end_days"]["preemption"] < \
        rep["hi_end_to_end_days"]["no_preemption"]
    lo = rep["preemption"]["jobs"]["lo"]
    assert lo["preemption"]["donations_given"] == 1
    hi_job = rep["preemption"]["jobs"]["hi"]
    assert hi_job["preemption"]["donations_taken"] == 1
    # without preemption the flagship waits for hardware instead
    assert rep["no_preemption"]["jobs"]["hi"]["recovery"][
        "waits_for_repair"] >= 1


def test_spare_pool_starvation_contends_without_double_grants():
    # DoubleGrantError inside the run would propagate; reaching a report at
    # all proves the arbitration invariant held under heavy contention
    rep = run_preset("spare_pool_starvation", seed=0)
    sched = rep["fleet"]["scheduler"]
    assert rep["pool_contended"] is True
    assert sched["claims_denied"] > 0
    assert all(j["finished_at_s"] > 0 for j in rep["jobs"].values())
    # starved recoveries visibly degraded at least one job
    ratios = [j["effective_time_ratio"] for j in rep["jobs"].values()]
    assert min(ratios) < 0.95


def test_queued_job_waits_for_capacity_then_runs():
    cfg = FleetConfig(
        jobs=(JobSpec("first", 6, ideal_hours=2.0),
              JobSpec("second", 6, ideal_hours=2.0)),
        n_nodes=8, n_spares=0)
    rep = run_fleet(cfg, seed=0)
    first, second = rep["jobs"]["first"], rep["jobs"]["second"]
    assert first["queue_wait_s"] == 0.0
    # the 8-node fleet cannot host both 6-node gangs at once
    assert second["queue_wait_s"] > 0
    assert second["admitted_at_s"] >= first["finished_at_s"]
    assert rep["fleet"]["scheduler"]["admitted"] == 2


def test_waiting_job_preempts_when_donor_finishes_its_own_recovery():
    # lo is mid-recovery (not donatable) when hi crashes with zero spares:
    # hi (min_nodes == n_nodes) must go WAITING — and then preempt lo the
    # moment lo's recovery closes, instead of stalling for repair_hours
    faults = (FaultEvent(1000.0, "node0004", "node_hw", degrades_only=False),
              FaultEvent(1100.0, "node0000", "node_hw", degrades_only=False))
    cfg = FleetConfig(
        jobs=(JobSpec("hi", 4, priority=10, min_nodes=4, ideal_hours=3.0),
              JobSpec("lo", 4, priority=1, min_nodes=2, ideal_hours=3.0)),
        n_nodes=8, n_spares=0, repair_hours=8.0, scripted=faults)
    rep = run_fleet(cfg, seed=0)
    hi, lo = rep["jobs"]["hi"], rep["jobs"]["lo"]
    assert hi["recovery"]["waits_for_repair"] == 1
    assert hi["preemption"]["donations_taken"] == 1
    assert lo["preemption"]["donations_given"] == 1
    # the wait ended at the donor's recovery close, hours before any repair
    assert hi["recovery"]["repair_wait_s"] < 3600.0
    assert hi["recovery"]["total_downtime_s"] < 8.0 * 3600.0 / 2


def test_torn_save_rolls_back_a_full_interval():
    # crash lands while the async save is still draining the shared NAS:
    # that checkpoint is torn, recovery resumes from the previous durable one
    crash = (FaultEvent(1801.0, "node0000", "node_hw", degrades_only=False),)
    cfg = FleetConfig(jobs=(JobSpec("solo", 4, ideal_hours=2.0,
                                    ckpt_bytes=32e9),),
                      n_nodes=4, n_spares=2, scripted=crash)
    rep = run_fleet(cfg, seed=0)
    j = rep["jobs"]["solo"]
    assert j["saves"]["torn"] == 1
    # nothing was durable yet -> the whole first interval is lost
    assert j["lost_steps"] == pytest.approx(1800 / 30, abs=1)


@pytest.mark.slow
def test_multi_job_soak_mode_is_deterministic_and_reports_goodput():
    from repro_torch.sim.soak import run_multi_job_soak

    a = run_multi_job_soak(job_sizes=(6, 4, 4), ideal_days=1.0, n_nodes=16,
                           n_spares=3, mtbf_node_days=10.0,
                           rack_mtbf_days=30.0, seed=3)
    b = run_multi_job_soak(job_sizes=(6, 4, 4), ideal_days=1.0, n_nodes=16,
                           n_spares=3, mtbf_node_days=10.0,
                           rack_mtbf_days=30.0, seed=3)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["engine"] == "fleet"
    assert set(a["jobs"]) == {"job0", "job1", "job2"}
    assert 0 < a["fleet"]["utilization"] <= 1.0
    assert a["one_clock"] is True
    for j in a["jobs"].values():
        assert 0 < j["effective_time_ratio"] <= 1.0


@pytest.mark.slow
def test_mixed_policy_fleet_isolates_policy_not_luck():
    rep = run_preset("mixed_policy_fleet", seed=0)
    assert rep["transom_beats_manual"] is True
    manual = rep["jobs"]["manual"]
    # the manual job's restores all hit the shared store (no ring backup)
    assert set(manual["restore_sources"]) <= {"store_full"}


# --------------------------------------------------------------------------- #
# fleet bench gate
# --------------------------------------------------------------------------- #
def _tiny_fleet_bench():
    return {
        "bench": "fleet",
        "presets": {"two_jobs_rack_outage": {"utilization": 0.9}},
        "preemption": {"gain": 20.0, "recovers_faster": True,
                       "hi_recovery_s": {"preemption": 600.0,
                                         "no_preemption": 12000.0}},
        "nas_contention": {"slowdown": 2.0},
    }


def test_fleet_bench_gate_trips_on_regressions():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir,
                        "scripts", "bench_gate.py")
    spec = importlib.util.spec_from_file_location("bench_gate_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    base = _tiny_fleet_bench()
    assert mod.gate_any(_tiny_fleet_bench(), base) == []
    worse = _tiny_fleet_bench()
    worse["presets"]["two_jobs_rack_outage"]["utilization"] = 0.5
    assert any("regressed" in m for m in mod.gate_any(worse, base))
    missing = _tiny_fleet_bench()
    missing["presets"] = {}
    assert any("missing" in m for m in mod.gate_any(missing, base))
    collapsed = _tiny_fleet_bench()
    collapsed["preemption"]["gain"] = 1.0
    assert any("collapsed" in m for m in mod.gate_any(collapsed, base))
    drifted = _tiny_fleet_bench()
    drifted["nas_contention"]["slowdown"] = 3.0
    assert any("drifted" in m for m in mod.gate_any(drifted, base))
    kinds = mod.gate_any(_tiny_fleet_bench(), {"bench": "fig6_e2e"})
    assert any("mismatch" in m for m in kinds)


# --------------------------------------------------------------------------- #
# from tests/test_recovery.py: regrow after repair
# --------------------------------------------------------------------------- #
def test_fleet_job_regrows_when_repair_lands():
    crash = (FaultEvent(3600.0, "node0001", "node_hw",
                        degrades_only=False),)
    cfg = FleetConfig(
        jobs=(JobSpec("solo", 4, min_nodes=2, ideal_hours=12.0),),
        n_nodes=4, n_spares=0, repair_hours=2.0, scripted=crash)
    rep = run_fleet(cfg, seed=0)
    j = rep["jobs"]["solo"]
    assert j["shrinks"] == 1
    assert j["regrows"] == 1                 # historically stayed shrunk
    assert j["final_nodes"] == 4
    # the regrow is a planned reshard: rollback + full store restore
    assert j["restore_sources"].get("store_full", 0) >= 2
    decisions = [e["decision"] for e in rep["decisions"]["log"]]
    assert decisions.index("shrink") < decisions.index("regrow")
    # the regrow entry fires at the repair instant, not at some later fault
    regrow_t = [e["t"] for e in rep["decisions"]["log"]
                if e["decision"] == "regrow"][0]
    assert regrow_t < 4 * 3600.0 + 600.0     # crash + repair_hours + slack


def test_fleet_regrow_preset_and_decision_log_deterministic():
    a = run_preset("shrink_then_regrow", seed=0)
    b = run_preset("shrink_then_regrow", seed=0)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["shrank_then_regrew"] is True
    assert a["finished_full_strength"] is True
    assert a["decision_arc"] == ["shrink", "regrow"]


def test_fleet_regrow_respects_priority_order():
    """Two shrunken jobs, one repaired machine: the higher-priority job
    reclaims it."""
    crashes = (FaultEvent(3600.0, "node0001", "node_hw",
                          degrades_only=False),
               FaultEvent(3600.0, "node0005", "node_hw",
                          degrades_only=False))
    cfg = FleetConfig(
        jobs=(JobSpec("hi", 4, priority=10, min_nodes=2, ideal_hours=12.0),
              JobSpec("lo", 4, priority=1, min_nodes=2, ideal_hours=12.0)),
        n_nodes=8, n_spares=0, repair_hours=2.0, preemption=False,
        scripted=crashes)
    rep = run_fleet(cfg, seed=0)
    hi, lo = rep["jobs"]["hi"], rep["jobs"]["lo"]
    assert hi["shrinks"] == 1 and lo["shrinks"] == 1
    regrows = [e for e in rep["decisions"]["log"]
               if e["decision"] == "regrow"]
    assert regrows and regrows[0]["job"] == "hi"


# --------------------------------------------------------------------------- #
# from tests/test_tee_stream.py: the fleet capstone
# --------------------------------------------------------------------------- #
def test_degrading_switch_folds_to_one_domain_incident():
    """One degrading switch seen by four jobs must open exactly ONE
    domain-level incident, correlate every touched job, and land its
    attribution confidence in the planner decision log."""
    rep = run_preset("degrading_switch_stream_tee", seed=0)
    assert rep["tee"]["n_domain_incidents"] == 1
    assert rep["one_domain_incident"]
    assert rep["all_jobs_correlated"]
    assert rep["confidence_in_decision_log"]
    inc = rep["tee"]["incidents"][0]
    assert len(inc["jobs"]) == 4
    assert 0.5 < inc["confidence"] <= 1.0
    # combined evidence from four witnesses beats any single job's
    assert inc["n_anomalies"] == 4


# --------------------------------------------------------------------------- #
# every fleet preset's report against the reference's
# --------------------------------------------------------------------------- #
def test_fleet_presets_are_the_reference_presets():
    from repro.fleet.presets import PRESETS as REF_PRESETS

    assert list(PRESETS) == list(REF_PRESETS)


@pytest.mark.parametrize("name", list(PRESETS))
def test_fleet_preset_equals_the_reference(name):
    from repro.fleet import run_preset as ref_run_preset

    def canon(rep):
        return json.dumps(strip_volatile(rep), sort_keys=True)

    assert canon(run_preset(name, seed=0)) == canon(ref_run_preset(name, seed=0))
