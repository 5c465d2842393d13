"""The port's mirror of ``tests/test_soak.py``: each of its tests run on
``repro_torch`` (the soak-backed scenarios on ``device="cpu"``), plus the
soak cases of ``tests/test_recovery.py`` and ``tests/test_tce_tiers.py``, and
the default sweep grid's report against the reference's. The reference's
docstring:

Time-triggered soak engine + policy sweep harness.

Covers the soak engine's determinism, the TRANSOM-vs-manual ordering on a
shared fault timeline, the spare-pool/shrink/wait policies, the restore
waterfall under heavy cascades, MTBF-scaled node counts, the sweep matrix,
the soak-backed scenario presets, and the CI bench-regression gate.
"""
import importlib.util
import json
import os

import pytest

from repro_torch.sim import nodes_for_fault_rate
from repro_torch.sim.soak import (SoakConfig, manual_policy, run_soak,
                                  transom_policy)
from repro_torch.sim.sweep import GRIDS, run_point, run_sweep


# --------------------------------------------------------------------------- #
# soak engine
# --------------------------------------------------------------------------- #
def _cfg(**kw):
    base = dict(ideal_days=3.0, n_nodes=8, n_spares=2,
                mtbf_node_days=20.0, seed=0)
    base.update(kw)
    return SoakConfig(**base)


def test_soak_is_deterministic():
    a = run_soak(_cfg())
    b = run_soak(_cfg())
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_soak_seed_changes_the_timeline():
    a = run_soak(_cfg(), seed=0)
    b = run_soak(_cfg(), seed=1)
    assert a["faults"]["injected"] != b["faults"]["injected"] \
        or a["end_to_end_days"] != b["end_to_end_days"]


def test_soak_completes_and_accounts_time():
    rep = run_soak(_cfg())
    assert rep["one_clock"] is True
    assert rep["end_to_end_days"] >= rep["config"]["ideal_days"]
    assert 0.0 < rep["effective_time_ratio"] <= 1.0
    # every restart restored from somewhere; hit_job counts faults that
    # *opened* a recovery (absorbed_in_recovery is disjoint: faults that
    # landed inside an already-open one)
    assert sum(rep["restore_sources"].values()) == \
        rep["recovery"]["restarts"]
    assert rep["recovery"]["restarts"] == rep["faults"]["hit_job"]


def test_transom_beats_manual_on_the_same_fault_timeline():
    t = run_soak(_cfg())
    m = run_soak(_cfg(policy=manual_policy()))
    # identical fault environment (policy-independent seeds)...
    assert t["faults"]["injected"] == m["faults"]["injected"]
    # ...but automated detection + async checkpoints finish sooner
    assert t["end_to_end_days"] < m["end_to_end_days"]
    assert t["effective_time_ratio"] > m["effective_time_ratio"]
    # the manual baseline has no in-memory caches: every restore hits NAS
    assert set(m["restore_sources"]) <= {"store_full"}


def test_soak_shrinks_when_pool_dry_and_policy_allows():
    rep = run_soak(_cfg(ideal_days=2.0, n_spares=0, shrink_threshold=0.5,
                        mtbf_node_days=6.0, repair_hours=240.0, seed=1))
    assert rep["fleet"]["shrinks"] >= 1
    assert rep["fleet"]["final_active"] < 8
    assert rep["fleet"]["final_active"] >= 4     # floor = ceil(0.5 * 8)


def test_soak_waits_for_repair_when_shrink_disabled():
    rep = run_soak(_cfg(ideal_days=2.0, n_spares=0, shrink_threshold=0.0,
                        mtbf_node_days=6.0, repair_hours=2.0, seed=1))
    assert rep["fleet"]["shrinks"] == 0
    assert rep["recovery"]["waits_for_repair"] >= 1
    assert rep["recovery"]["repair_wait_s"] > 0
    # stalls waiting for hardware are not restart latency
    assert rep["recovery"]["mean_restart_s"] * \
        rep["recovery"]["restarts"] <= rep["recovery"]["total_downtime_s"]


@pytest.mark.slow
def test_heavy_cascades_force_restores_down_the_waterfall():
    # p_cascade=1 with a short window: follow-on faults land inside the open
    # recovery transaction (absorbed), and node-attributable ones join its
    # victim set — double deaths that push restores past the ring backup to
    # the persistent store, alongside cache and backup restores
    rep = run_soak(_cfg(ideal_days=8.0, n_nodes=4, n_spares=6,
                        mtbf_node_days=2.0, p_cascade=1.0,
                        cascade_window_s=300.0, seed=2))
    assert rep["faults"]["cascades"] >= 1
    assert rep["faults"]["absorbed_in_recovery"] >= 1
    # the full waterfall was exercised: cache, ring backup, store
    assert rep["restore_sources"].get("cache", 0) >= 1
    assert rep["restore_sources"].get("backup", 0) >= 1
    assert rep["restore_sources"].get("store_full", 0) >= 1


def test_rack_outages_hit_whole_domains():
    rep = run_soak(_cfg(ideal_days=4.0, n_nodes=8, n_spares=8,
                        nodes_per_rack=4, rack_mtbf_days=8.0,
                        mtbf_node_days=1000.0))
    assert rep["faults"]["domain_outages"] >= 2   # members of >= 1 outage


# --------------------------------------------------------------------------- #
# MTBF-scaled node counts
# --------------------------------------------------------------------------- #
def test_nodes_for_fault_rate_matches_anchors():
    # BLOOM: ~1-2 faults/week on ~48 nodes -> MTBF in the 170-340 d band
    assert nodes_for_fault_rate(1.5, 224.0) == 48
    # paper's Fig. 6 cluster: 64 nodes at 110 d MTBF
    assert nodes_for_fault_rate(64 * 7 / 110.0, 110.0) == 64
    assert nodes_for_fault_rate(0.1, 7.0) == 1    # floor at one node
    with pytest.raises(ValueError):
        nodes_for_fault_rate(0.0, 30.0)


# --------------------------------------------------------------------------- #
# policy sweep
# --------------------------------------------------------------------------- #
@pytest.mark.slow
def test_sweep_small_grid_is_deterministic_and_complete():
    a = run_sweep("small", seed=0)
    b = run_sweep("small", seed=0)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    spec = GRIDS["small"]
    expect = (len(spec["ckpt_cadence_s"]) * len(spec["spare_pool"])
              * len(spec["shrink_threshold"])
              * len(spec["fault_rate_per_week"]))
    assert a["n_points"] == expect == len(a["points"])
    assert a["frontier"]
    for p in a["points"]:
        assert p["transom"]["policy"] == "transom"
        assert p["baseline"]["policy"] == "manual"
        assert p["speedup"] > 0


def test_default_grid_covers_at_least_24_points():
    spec = GRIDS["default"]
    n = (len(spec["ckpt_cadence_s"]) * len(spec["spare_pool"])
         * len(spec["shrink_threshold"]) * len(spec["fault_rate_per_week"]))
    assert n >= 24


def test_sweep_point_pairs_policies_on_one_fault_env():
    p = run_point(1800.0, 2, 0.5, 2.0, seed=3, ideal_days=2.0)
    assert p["transom"]["faults"]["injected"] == \
        p["baseline"]["faults"]["injected"]
    assert p["policy"]["n_nodes"] == nodes_for_fault_rate(2.0, 110.0)
    assert p["improvement_pct"] == pytest.approx(
        100.0 * (1 - p["transom"]["end_to_end_days"]
                 / p["baseline"]["end_to_end_days"]), abs=0.01)


def test_unknown_grid_raises():
    with pytest.raises(KeyError):
        run_sweep("nope")


# --------------------------------------------------------------------------- #
# scenario presets over the soak engine
# --------------------------------------------------------------------------- #
@pytest.mark.slow
def test_soak_scenarios_registered_and_deterministic():
    from repro_torch.sim.scenarios import SCENARIOS, run_scenario

    assert "weeklong_soak" in SCENARIOS
    assert "policy_frontier" in SCENARIOS
    a = run_scenario("weeklong_soak", seed=0, device="cpu")
    b = run_scenario("weeklong_soak", seed=0, device="cpu")
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert a["scenario"] == "weeklong_soak"
    assert a["engine"] == "soak"
    assert a["config"]["ideal_days"] == 7.0
    f = run_scenario("policy_frontier", seed=0, device="cpu")
    assert f["n_points"] == len(f["points"]) >= 4
    assert f["one_clock"] is True


# --------------------------------------------------------------------------- #
# bench-regression gate
# --------------------------------------------------------------------------- #
def _load_by_path(name, *parts):
    path = os.path.join(os.path.dirname(__file__), os.pardir, *parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_bench_gate():
    return _load_by_path("bench_gate", "scripts", "bench_gate.py")


def _tiny_bench():
    return {
        "paper_point": {"improvement_pct": 30.0},
        "sweep": {"points": [
            {"policy": {"ckpt_cadence_s": 1800.0, "spare_pool": 8,
                        "shrink_threshold": 0.0,
                        "fault_rate_per_week": 4.0},
             "effective_time_ratio": 0.98},
        ]},
    }


def test_bench_gate_passes_identical_and_trips_on_regression():
    gate = _load_bench_gate().gate
    base = _tiny_bench()
    assert gate(_tiny_bench(), base) == []
    worse = _tiny_bench()
    worse["sweep"]["points"][0]["effective_time_ratio"] = 0.90
    assert any("regressed" in m for m in gate(worse, base))
    missing = _tiny_bench()
    missing["sweep"]["points"] = []
    assert any("missing" in m for m in gate(missing, base))
    collapsed = _tiny_bench()
    collapsed["paper_point"]["improvement_pct"] = 10.0
    assert any("collapsed" in m for m in gate(collapsed, base))


@pytest.mark.slow
def test_committed_fig6_baseline_matches_current_code():
    # the committed baseline must be reproducible by the current tree,
    # otherwise the CI bench gate drifts into vacuity
    baseline_path = os.path.join(os.path.dirname(__file__), os.pardir,
                                 "benchmarks", "baselines",
                                 "BENCH_fig6.json")
    fig6 = _load_by_path("fig6_e2e", "benchmarks", "fig6_e2e.py")
    with open(baseline_path) as f:
        committed = json.load(f)
    assert _load_bench_gate().gate(fig6.build_payload(seed=0),
                                   committed) == []


# --------------------------------------------------------------------------- #
# from tests/test_recovery.py and tests/test_tce_tiers.py: soak decisions
# and the tiered outage
# --------------------------------------------------------------------------- #
def test_soak_report_carries_decision_log():
    rep = run_soak(SoakConfig(ideal_days=2.0, n_nodes=8, n_spares=0,
                              mtbf_node_days=6.0, repair_hours=240.0,
                              shrink_threshold=0.5, seed=2))
    dec = rep["decisions"]
    assert dec["n"] == sum(dec["by_decision"].values()) > 0
    assert dec["by_decision"].get("shrink", 0) >= 1
    assert len(dec["log"]) <= 40
    json.dumps(rep)


def test_soak_planner_policy_is_runtime_selectable():
    """Chameleon-style: the same fault timeline under a different planner
    policy recovers differently (no_shrink waits instead of degrading)."""
    base = dict(ideal_days=2.0, n_nodes=8, n_spares=0, mtbf_node_days=6.0,
                repair_hours=2.0, shrink_threshold=0.5, seed=1)
    shrinky = run_soak(SoakConfig(**base))
    waity = run_soak(SoakConfig(planner_policy="no_shrink", **base))
    assert shrinky["faults"]["injected"] == waity["faults"]["injected"]
    assert shrinky["fleet"]["shrinks"] >= 1
    assert waity["fleet"]["shrinks"] == 0
    assert waity["recovery"]["waits_for_repair"] >= 1


def test_soak_tiered_outage_reports_tier_sources_and_cadence():
    from repro_torch.recovery import TIER_COLD, TIER_PEER, TIER_SSD
    from repro_torch.sim.soak import DAY_S

    rep = run_soak(SoakConfig(ideal_days=7.0, n_nodes=16, n_spares=2,
                              mtbf_node_days=9.0, p_cascade=0.3,
                              rack_mtbf_days=25.0, tiers=True,
                              adaptive_cadence=True,
                              nas_outages=((2 * DAY_S, 2 * DAY_S),)),
                   seed=0)
    srcs = rep["restore_sources"]
    # the NAS brownout + rack correlation force restores off the beaten
    # path: durable non-NAS tiers must appear
    assert any(t in srcs for t in (TIER_SSD, TIER_PEER, TIER_COLD))
    assert rep["cadence"]["adaptions"] > 0
    assert rep["config"]["tiers"] is True


# --------------------------------------------------------------------------- #
# the port's sweep against the reference's
# --------------------------------------------------------------------------- #
def test_default_sweep_equals_the_reference():
    from repro.sim.sweep import run_sweep as ref_run_sweep
    from repro_torch.report import strip_volatile

    def canon(rep):
        return json.dumps(strip_volatile(rep), sort_keys=True)

    port = run_sweep("default", seed=0)
    assert port["n_points"] > 0
    assert canon(port) == canon(ref_run_sweep("default", seed=0))
