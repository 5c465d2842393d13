"""Named fleet scenarios: multi-job presets over the fleet engine.

Each preset is a seeded, deterministic configuration of
:class:`~repro.fleet.engine.FleetConfig`; reports are byte-identical across
runs at the same seed (enforced in CI). They are also registered into the
``repro.sim.scenarios`` catalog, so ``python -m repro.sim.scenarios --list``
shows the whole fleet alongside the single-job scenarios.

    python -m repro.fleet --list
    python -m repro.fleet --run two_jobs_rack_outage --seed 0
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, List

from repro_torch.sim.faults import FaultEvent
from repro_torch.sim.soak import manual_policy, transom_policy

from .engine import FleetConfig, no_preemption, run_fleet
from .scheduler import JobSpec


@dataclass(frozen=True)
class FleetPreset:
    name: str
    description: str
    run: Callable[[int], dict]     # seed -> JSON-able report


PRESETS: Dict[str, FleetPreset] = {}


def preset(name: str, description: str):
    def deco(fn: Callable[[int], dict]) -> Callable[[int], dict]:
        PRESETS[name] = FleetPreset(name, description, fn)
        return fn
    return deco


def _job(name: str, n_nodes: int = 4, **kw) -> JobSpec:
    kw.setdefault("ideal_hours", 6.0)
    kw.setdefault("policy", transom_policy())
    return JobSpec(name, n_nodes, **kw)


# --------------------------------------------------------------------------- #
@preset("two_jobs_rack_outage",
        "Two jobs co-located on one rack; the rack dies at t=2h in ONE "
        "correlated event hitting both jobs, whose store restores then "
        "contend for the shared NAS uplink.")
def two_jobs_rack_outage(seed: int = 0) -> dict:
    # nodes_per_rack=8 -> rack00 = node0000..0007 hosts both 4-node jobs;
    # the 8 spares live in later racks, outside the failed domain
    outage = [FaultEvent(2 * 3600.0, f"node{i:04d}", "network",
                         degrades_only=False, domain="rack00")
              for i in range(8)]
    cfg = FleetConfig(
        jobs=(_job("jobA"), _job("jobB")),
        n_nodes=8, n_spares=8, nodes_per_rack=8,
        scripted=tuple(outage), seed=seed)
    rep = run_fleet(cfg, seed=seed)
    hit = [e for e in rep["correlated_events"]
           if e["domain"] == "rack00" and len(e["jobs"]) == 2]
    return dict(rep, scenario="two_jobs_rack_outage",
                both_jobs_hit_in_same_event=bool(hit))


@preset("priority_preemption",
        "A high-priority job loses a node with the spare pool dry; with "
        "preemption the low-priority job donates a machine (recovery in "
        "minutes), without it the job stalls until repairs land (hours).")
def priority_preemption(seed: int = 0) -> dict:
    crash = (FaultEvent(3600.0, "node0001", "node_hw",
                        degrades_only=False),)
    cfg = FleetConfig(
        jobs=(_job("hi", priority=10, min_nodes=4),     # flagship: no shrink
              _job("lo", priority=1, min_nodes=2)),     # elastic
        n_nodes=8, n_spares=0, repair_hours=4.0,
        scripted=crash, seed=seed)
    with_p = run_fleet(cfg, seed=seed)
    without = run_fleet(no_preemption(cfg), seed=seed)
    hi_p, hi_n = with_p["jobs"]["hi"], without["jobs"]["hi"]
    return {
        "scenario": "priority_preemption",
        "seed": seed,
        "same_fault_timeline": (with_p["faults"]["injected"]
                                == without["faults"]["injected"]),
        "preemption": with_p,
        "no_preemption": without,
        "hi_recovery_s": {
            "preemption": hi_p["recovery"]["total_downtime_s"],
            "no_preemption": hi_n["recovery"]["total_downtime_s"],
        },
        "hi_end_to_end_days": {
            "preemption": hi_p["end_to_end_days"],
            "no_preemption": hi_n["end_to_end_days"],
        },
        "preemption_recovers_faster": (
            hi_p["recovery"]["total_downtime_s"]
            < hi_n["recovery"]["total_downtime_s"]),
        "one_clock": with_p["one_clock"] and without["one_clock"],
    }


@preset("spare_pool_starvation",
        "Three jobs vs one spare under a heavy stochastic fault mix: the "
        "claim ledger arbitrates every replacement, losers shrink or wait "
        "for repairs; no node is ever double-granted.")
def spare_pool_starvation(seed: int = 0) -> dict:
    cfg = FleetConfig(
        jobs=(_job("etl", priority=0, min_nodes=2, ideal_hours=24.0),
              _job("pretrain", priority=5, min_nodes=2, ideal_hours=24.0),
              _job("ablation", priority=0, min_nodes=2, ideal_hours=24.0)),
        n_nodes=12, n_spares=1, nodes_per_rack=4, repair_hours=12.0,
        mtbf_node_days=0.8, horizon_days=16.0, p_cascade=0.2,
        seed=seed)
    rep = run_fleet(cfg, seed=seed)
    sched = rep["fleet"]["scheduler"]
    return dict(rep, scenario="spare_pool_starvation",
                pool_contended=sched["claims_denied"] > 0)


@preset("shrink_then_regrow",
        "An elastic job loses a node with the pool dry and shrinks; when "
        "the repair lands the RecoveryPlanner takes the regrow rung — the "
        "job pays a planned reshard and finishes at full strength (the "
        "whole arc is visible in the deterministic decision log).")
def shrink_then_regrow(seed: int = 0) -> dict:
    crash = (FaultEvent(3600.0, "node0002", "node_hw",
                        degrades_only=False),)
    cfg = FleetConfig(
        jobs=(_job("elastic", n_nodes=4, min_nodes=2, ideal_hours=12.0),),
        n_nodes=4, n_spares=0, repair_hours=2.0,
        scripted=crash, seed=seed)
    rep = run_fleet(cfg, seed=seed)
    j = rep["jobs"]["elastic"]
    decisions = [e["decision"] for e in rep["decisions"]["log"]]
    return dict(rep, scenario="shrink_then_regrow",
                decision_arc=decisions,
                shrank_then_regrew=(j["shrinks"] >= 1 and j["regrows"] >= 1
                                    and decisions.index("shrink")
                                    < decisions.index("regrow")
                                    if {"shrink", "regrow"} <=
                                    set(decisions) else False),
                finished_full_strength=j["final_nodes"] == 4)


@preset("fleet_week_soak",
        "The soak engine's multi-job mode: three mixed-priority jobs share "
        "16 nodes for days of modelled training under the Table-I mix plus "
        "rack outages, reporting per-job and fleet-level goodput.")
def fleet_week_soak(seed: int = 0) -> dict:
    from repro_torch.sim.soak import run_multi_job_soak

    rep = run_multi_job_soak(
        job_sizes=(6, 4, 4), ideal_days=2.0, n_nodes=16, n_spares=3,
        mtbf_node_days=25.0, rack_mtbf_days=60.0, seed=seed)
    return dict(rep, scenario="fleet_week_soak")


@preset("mixed_policy_fleet",
        "A TRANSOM-managed job and a manual-baseline job side by side on "
        "one topology and one fault environment: fleet-level proof that "
        "detection+restore policy, not luck, drives the goodput gap.")
def mixed_policy_fleet(seed: int = 0) -> dict:
    cfg = FleetConfig(
        jobs=(_job("transom", n_nodes=6, ideal_hours=24.0,
                   policy=transom_policy()),
              _job("manual", n_nodes=6, ideal_hours=24.0,
                   policy=manual_policy())),
        n_nodes=12, n_spares=4, nodes_per_rack=6,
        mtbf_node_days=1.0, horizon_days=20.0, seed=seed)
    rep = run_fleet(cfg, seed=seed)
    jt, jm = rep["jobs"]["transom"], rep["jobs"]["manual"]
    return dict(rep, scenario="mixed_policy_fleet",
                transom_beats_manual=(jt["effective_time_ratio"]
                                      > jm["effective_time_ratio"]))


@preset("degrading_switch_stream_tee",
        "Eagle Eye: one switch degrades under four co-located jobs; each "
        "job's metric stream shows a slow rank, the streaming TEE scores "
        "all four in one vectorized pass, and the cross-job correlator "
        "folds the four anomalies into ONE confidence-weighted domain "
        "incident — planned once, not four times.")
def degrading_switch_stream_tee(seed: int = 0) -> dict:
    # nodes_per_rack=8, racks_per_switch=4 -> switch00 = node0000..0031;
    # four 8-node jobs land one per rack under that switch. The switch
    # degrades (slow, not dead) at t=2h: one slow node per job, all tagged
    # with the shared failure domain
    degrade = [FaultEvent(2 * 3600.0, f"node{i:04d}", "network",
                          degrades_only=True, domain="switch00")
               for i in (1, 9, 17, 25)]
    cfg = FleetConfig(
        jobs=tuple(_job(f"job{c}", n_nodes=8, min_nodes=4)
                   for c in "ABCD"),
        n_nodes=32, n_spares=8, nodes_per_rack=8, racks_per_switch=4,
        scripted=tuple(degrade), tee_stream=True, seed=seed)
    rep = run_fleet(cfg, seed=seed)
    tee = rep["tee"]
    conf_entries = [e for e in rep["decisions"]["log"] if "confidence" in e]
    return dict(
        rep, scenario="degrading_switch_stream_tee",
        # the acceptance bar: one switch event -> ONE domain-level incident
        one_domain_incident=tee["n_domain_incidents"] == 1,
        all_jobs_correlated=(tee["incidents"]
                             and len(tee["incidents"][0]["jobs"]) == 4),
        confidence_in_decision_log=bool(conf_entries),
        domain_confidence=(tee["incidents"][0]["confidence"]
                           if tee["incidents"] else None))


@preset("rack_outage_tiered",
        "The rack outage replayed over the N-tier hierarchy: the peer-ring "
        "tier shares the rack failure domain (tier_correlated), so both "
        "jobs escalate to the store — but speculative restore prefetch "
        "streams each checkpoint on the shared NAS during the reschedule "
        "window, so the restore leg finds the bytes already staged. "
        "Reported against the same outage without prefetch.")
def rack_outage_tiered(seed: int = 0) -> dict:
    outage = [FaultEvent(2 * 3600.0, f"node{i:04d}", "network",
                         degrades_only=False, domain="rack00")
              for i in range(8)]
    cfg = FleetConfig(
        jobs=(_job("jobA"), _job("jobB")),
        n_nodes=8, n_spares=8, nodes_per_rack=8,
        scripted=tuple(outage), tier_correlated=True,
        restore_prefetch=True, seed=seed)
    with_pf = run_fleet(cfg, seed=seed)
    baseline = run_fleet(replace(cfg, restore_prefetch=False), seed=seed)
    downtime = {
        "prefetch": {n: j["recovery"]["total_downtime_s"]
                     for n, j in with_pf["jobs"].items()},
        "no_prefetch": {n: j["recovery"]["total_downtime_s"]
                        for n, j in baseline["jobs"].items()},
    }
    hits = sum(j["prefetch"]["hits"] for j in with_pf["jobs"].values())
    return dict(with_pf, scenario="rack_outage_tiered",
                no_prefetch=baseline,
                downtime_s=downtime,
                prefetch_hits=hits,
                prefetch_wins=all(
                    downtime["prefetch"][n] < downtime["no_prefetch"][n]
                    for n in downtime["prefetch"]))


@preset("demotion_contention",
        "Background TieredStore demotions routed through the fleet's shared "
        "NAS arbiter: scripted step-aging flows land on every checkpoint "
        "cadence tick, so the job's async saves drain contended instead of "
        "solo — same job, same timeline, measurably busier uplink than the "
        "demotion-free baseline.")
def demotion_contention(seed: int = 0) -> dict:
    # one 4-node job saving every 1800 productive seconds; with no faults
    # wall time == productive time, so demotion flows scheduled on the
    # cadence grid are in flight exactly when each save starts
    demote = tuple((1800.0 * k, 32e9) for k in range(1, 12))
    cfg = FleetConfig(jobs=(_job("train", ideal_hours=6.0),),
                      n_nodes=8, n_spares=2, demotion_traffic=demote,
                      seed=seed)
    with_d = run_fleet(cfg, seed=seed)
    baseline = run_fleet(replace(cfg, demotion_traffic=()), seed=seed)
    nas_d = with_d["fleet"]["nas"]
    nas_b = baseline["fleet"]["nas"]
    return dict(with_d, scenario="demotion_contention",
                no_demotion=baseline,
                contended_flows={"demotion": nas_d["contended_flows"],
                                 "baseline": nas_b["contended_flows"]},
                demotion_contends_with_saves=(
                    nas_d["contended_flows"] > nas_b["contended_flows"]
                    and nas_d["demotions"]["drained"]
                    == nas_d["demotions"]["started"] > 0))


# --------------------------------------------------------------------------- #
def run_preset(name: str, seed: int = 0, profile: bool = False) -> dict:
    """Run one fleet preset. ``profile=True`` attaches the volatile
    ``measured`` section (wall time, tick count, per-phase dispatcher
    breakdown) to every fleet report the preset produces — the simulation
    and the report body are unchanged."""
    if name not in PRESETS:
        raise KeyError(f"unknown fleet preset {name!r}; have: "
                       f"{', '.join(sorted(PRESETS))}")
    from repro_torch.report import finalize

    from .engine import set_profile

    if profile:
        set_profile(True)
    try:
        rep = PRESETS[name].run(seed)
    finally:
        if profile:
            set_profile(False)
    # re-finalize: presets add keys on top of run_fleet's report, so the
    # timeline digest must be recomputed over the final shape
    return finalize(rep, scenario=name, seed=seed)


def preset_names() -> List[str]:
    return sorted(PRESETS)
