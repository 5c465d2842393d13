"""Named end-to-end fault scenarios on the unified simulation substrate.

Every scenario builds ONE substrate — one :class:`SimClock`, one
:class:`Topology`, one fault model — and is a thin preset over one of two
engines:

* **closed-loop presets** drive the full TEE -> TOL -> TCE loop step by
  step: the fault script is a list of ``(step, action)`` entries drained
  through an :class:`EventQueue` keyed on step index, TEE scores traces
  generated from the *injected* faults, TOL evicts/reschedules/shrinks/
  grows, TCE restores through the memory -> ring-backup -> store waterfall.
* **soak presets** (``weeklong_soak``, ``policy_frontier``) hand a
  :class:`repro.sim.soak.SoakConfig` to the time-triggered soak engine:
  faults fire at simulated *timestamps* (days of training) from
  ``FaultInjector.schedule()`` / ``cascade_events`` pushed onto the shared
  queue, and ``policy_frontier`` sweeps policy knobs over that engine.

Either way the run emits a deterministic (seeded) JSON report: recovery
time, lost steps, restore source mix, the FSM path (closed loop), and a
clock-identity check proving all subsystems shared one timeline.

Usage:

    python -m repro.sim.scenarios --list
    python -m repro.sim.scenarios --run single_node_crash
    python -m repro.sim.scenarios --run all --json reports.json

Counterpart of ``repro.sim.scenarios``: the reference's source with the
import prefix rewritten and one departure, an explicit device. Every
scenario takes ``device=None`` and hands it to each substrate it builds
(``build_sim_substrate`` resolves it: the card unless ``"cpu"`` is asked
for), whose TOL burn-ins are the modelled cluster's only device work.
``run_scenario(name, seed, device)`` and the CLI's ``--device`` pass it
down; the soak, sweep and fleet presets touch no device and ignore it.
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .clock import EventQueue
from .topology import NodeState


# --------------------------------------------------------------------------- #
# Substrate: the one-of-everything bundle. Promoted to the first-class
# repro.substrate package in PR 7; re-exported here because tests,
# benchmarks and examples historically import it from this module.
# --------------------------------------------------------------------------- #
from repro_torch.substrate.sim import (SimSubstrate as Substrate,  # noqa: F401
                                 _fitted_tee,
                                 build_sim_substrate as build_substrate)


# --------------------------------------------------------------------------- #
# Closed-loop runner
# --------------------------------------------------------------------------- #
def _train_state(n: int = 256) -> Dict[str, np.ndarray]:
    return {"w": np.zeros((n,), np.float32),
            "opt/m": np.zeros((n,), np.float32)}


def _step_fn(state: Dict[str, np.ndarray], step: int) -> Dict[str, np.ndarray]:
    return {"w": state["w"] + 1.0, "opt/m": state["opt/m"] * 0.9 + 0.1}


# a closed-loop fault script: (step, action) entries; actions may raise
# SimulatedFault to interrupt training at that step
StepScript = Sequence[Tuple[int, Callable[[], None]]]


def _script_hook(script: StepScript) -> Callable[[int], None]:
    """Compile a step-keyed fault script into a ``fault_hook``.

    The script drains through an :class:`EventQueue` whose private clock
    counts *step indices* rather than seconds: each entry fires exactly
    once, at the first step that reaches its index. An action that raises
    (``SimulatedFault``) leaves later entries queued, so they fire after
    recovery rewinds and the loop climbs back to their step.
    """
    q = EventQueue()
    for at_step, action in script:
        q.push(float(at_step), action)

    def hook(step: int) -> None:
        while q and q.peek_time() <= step:
            _, action = q.pop(advance_clock=True)
            action()
    return hook


def _run_closed_loop(sub: Substrate, steps: int, ckpt_every: int,
                     script: Optional[StepScript] = None,
                     fault_hook: Optional[Callable[[int], None]] = None,
                     allow_shrink: bool = False, min_nodes: int = 2,
                     costs=None) -> Tuple["object", Dict[str, np.ndarray]]:
    from repro_torch.core.tol import JobConfig
    from repro_torch.core.tol.orchestrator import PhaseCosts

    if script is not None:
        assert fault_hook is None, "pass either script or fault_hook"
        fault_hook = _script_hook(script)
    cfg = JobConfig(total_steps=steps, ckpt_every=ckpt_every,
                    n_sim_nodes=len(sub.topology.assigned),
                    allow_shrink=allow_shrink, min_nodes=min_nodes,
                    costs=costs or PhaseCosts())
    report, state = sub.operator.run_job(cfg, _train_state(), _step_fn,
                                         fault_hook=fault_hook)
    return report, state


def _report_dict(name: str, seed: int, sub: Substrate, report,
                 extra: Optional[dict] = None) -> dict:
    tce = sub.operator.tce    # may have been rebuilt by shrink/grow
    # drain the async durability pipeline first: its modelled charges
    # (NAS writes, digest/encode CPU) must land before clock_s is read,
    # or the report would race the reconciler thread
    tce.reconciler.quiesce(10)
    out = {
        "scenario": name,
        "seed": seed,
        "completed": report.completed,
        "steps_done": report.steps_done,
        "lost_steps": report.lost_steps,
        "restarts": {"inplace": report.restarts_inplace,
                     "resched": report.restarts_resched},
        "shrinks": report.shrinks,
        "final_nodes": report.final_nodes,
        "evicted_nodes": sorted(report.evicted_nodes),
        "recovery": {
            "mean_restart_s": round(report.mean_restart_s, 3),
            "total_downtime_s": round(report.modeled_downtime_s, 3),
            "restart_times_s": [round(t, 3)
                                for t in report.modeled_restart_times],
        },
        "restore_sources": dict(report.restore_sources),
        "ring_fetches": {"requests": tce.stats.get("fetch_requests", 0),
                         "transfers": tce.stats.get("fetch_transfers", 0)},
        "tee_verdicts": report.tee_verdicts,
        "fabric": {"transfers": tce.fabric.transfers,
                   "bytes_moved": tce.fabric.bytes_moved},
        "clock_s": round(sub.clock.seconds, 3),
        "fsm_path": [s for _, s, _ in report.state_history],
        # the RecoveryPlanner's structured decision log (closed-loop entries
        # are step-indexed: `t` is the step the incident interrupted)
        "decisions": {"n": len(report.decisions), "log": report.decisions},
        "one_clock": sub.clock_identity_ok(),
    }
    if extra:
        out.update(extra)
    return out


# --------------------------------------------------------------------------- #
# Scenario registry
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    run: Callable[..., dict]       # (seed, device) -> JSON-able report


SCENARIOS: Dict[str, Scenario] = {}


def scenario(name: str, description: str):
    def deco(fn: Callable[[int], dict]) -> Callable[[int], dict]:
        SCENARIOS[name] = Scenario(name, description, fn)
        return fn
    return deco


def _fail_rank(sub: Substrate, rank: int, category: str,
               degrades_only: bool = False, quiesce: bool = True):
    """Mark the node hosting `rank` bad on the shared topology and raise the
    corresponding fault into the training loop.

    By default the durability pipeline is quiesced first (the fault strikes
    in steady state, not mid-save) so the recovery point — and therefore the
    whole JSON report — is deterministic. ``save_racing_crash`` opts out to
    model exactly that race.
    """
    from repro_torch.core.tol.orchestrator import SimulatedFault

    if quiesce:
        sub.operator.tce.reconciler.quiesce(10)
    node = sub.operator.launchers[rank].node
    n = sub.topology.nodes[node]
    n.state = NodeState.DEGRADED if degrades_only else NodeState.FAILED
    n.fail_category = category
    raise SimulatedFault(category, rank, degrades_only)


# --------------------------------------------------------------------------- #
@scenario("single_node_crash",
          "One node dies of a hardware fault mid-run; TEE attributes it, TOL "
          "evicts + reschedules onto a spare, TCE restores from ring backup.")
def _single_node_crash(seed: int = 0, device=None) -> dict:
    sub = build_substrate(n_nodes=4, n_spares=2, device=device)
    report, state = _run_closed_loop(
        sub, steps=30, ckpt_every=5,
        script=[(12, lambda: _fail_rank(sub, 1, "node_hw"))])
    out = _report_dict("single_node_crash", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("straggler",
          "A slow node degrades the whole job (tail latency at collectives); "
          "detected as a degradation, evicted, replaced.")
def _straggler(seed: int = 0, device=None) -> dict:
    sub = build_substrate(n_nodes=4, n_spares=2, device=device)
    report, state = _run_closed_loop(
        sub, steps=30, ckpt_every=5,
        script=[(14, lambda: _fail_rank(sub, 2, "node_hw",
                                        degrades_only=True))])
    out = _report_dict("straggler", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("flapping_link",
          "A link flaps: the first drop self-heals before checks complete "
          "(in-place restart), the second sticks (evict + reschedule).")
def _flapping_link(seed: int = 0, device=None) -> dict:
    from repro_torch.core.tol.orchestrator import SimulatedFault

    sub = build_substrate(n_nodes=4, n_spares=2, device=device)

    def transient_flap():
        # transient flap: link is back up by the time error checks run,
        # so no node is attributable -> in-place restart
        raise SimulatedFault("network", 3)

    report, state = _run_closed_loop(
        sub, steps=30, ckpt_every=5,
        script=[(8, transient_flap),
                # the flap sticks: node marked degraded, network category
                (16, lambda: _fail_rank(sub, 3, "network",
                                        degrades_only=True))])
    out = _report_dict("flapping_link", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("correlated_switch_failure",
          "A leaf switch dies and takes out its whole rack at once; "
          "replacements are anti-affinity-placed outside the failed domain.")
def _correlated_switch_failure(seed: int = 0, device=None) -> dict:
    from repro_torch.core.tol.orchestrator import SimulatedFault

    # nodes_per_rack=2 -> rack00={node0000,node0001}, rack01={node0002,...}
    sub = build_substrate(n_nodes=4, n_spares=4, nodes_per_rack=2,
                          device=device)
    rack = sub.topology.domain_of("node0000", "rack")

    def kill_rack():
        sub.tce.reconciler.quiesce(10)
        hit = sub.topology.fail_domain("rack", rack, t=sub.clock.seconds,
                                       category="network")
        assert len(hit) >= 2, hit
        raise SimulatedFault("network", 0)

    report, state = _run_closed_loop(sub, steps=30, ckpt_every=5,
                                     script=[(12, kill_rack)])
    # every replacement must sit outside the failed rack
    racks_now = {sub.topology.domain_of(l.node, "rack")
                 for l in sub.operator.launchers}
    out = _report_dict("correlated_switch_failure", seed, sub, report,
                       {"failed_domain": rack,
                        "replacement_racks": sorted(racks_now),
                        "domain_avoided": rack not in racks_now,
                        "final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("storage_stall",
          "Shared storage stalls (IO wait spikes, compute idles); no node is "
          "at fault, so the job restarts in place after the stall clears.")
def _storage_stall(seed: int = 0, device=None) -> dict:
    from repro_torch.core.tol.orchestrator import SimulatedFault

    sub = build_substrate(n_nodes=4, n_spares=2, device=device)

    def stall():
        # infrastructure fault: no node transitions to FAILED
        raise SimulatedFault("storage", 0)

    report, state = _run_closed_loop(sub, steps=30, ckpt_every=5,
                                     script=[(10, stall)])
    out = _report_dict("storage_stall", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("cascading_double_fault",
          "A crash, then a correlated adjacent-pair crash during the catch-up "
          "window: ring backups are gone, restore falls through to the store.")
def _cascading_double_fault(seed: int = 0, device=None) -> dict:
    sub = build_substrate(n_nodes=4, n_spares=4, device=device)

    def cascade():
        # cascade while the first recovery is still settling: ranks 2 and
        # 3 are ring neighbours, so rank 2's backup (held by 3) dies too
        node3 = sub.operator.launchers[3].node
        sub.topology.nodes[node3].state = NodeState.FAILED
        sub.topology.nodes[node3].fail_category = "node_hw"
        _fail_rank(sub, 2, "node_hw")

    report, state = _run_closed_loop(
        sub, steps=30, ckpt_every=5,
        script=[(12, lambda: _fail_rank(sub, 1, "node_hw")),
                (13, cascade)])
    out = _report_dict("cascading_double_fault", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


@scenario("elastic_shrink_then_grow",
          "Spare pool empty: the job shrinks to the survivors (checkpoint "
          "reshards through the store), then grows back once repairs land.")
def _elastic_shrink_then_grow(seed: int = 0, device=None) -> dict:
    sub = build_substrate(n_nodes=4, n_spares=0, device=device)
    grown = {"n": 0}

    def repairs_land():
        # repairs complete: heal cordoned nodes, clear anti-affinity,
        # and elastically grow back to the original fleet size
        sub.topology.repair_due(sub.clock.seconds + sub.topology.repair_s)
        for n in list(sub.server.bad_nodes()):
            sub.server.clear_bad_node(n)
        grown["n"] = sub.operator.grow(1)

    report, state = _run_closed_loop(
        sub, steps=30, ckpt_every=5,
        script=[(10, lambda: _fail_rank(sub, 2, "node_hw")),
                (20, repairs_land)],
        allow_shrink=True, min_nodes=2)
    out = _report_dict("elastic_shrink_then_grow", seed, sub, report,
                       {"grows": grown["n"],
                        "final_w": float(state["w"][0])})
    sub.close()
    return out


@functools.lru_cache(maxsize=1)
def _weekend_closed_loop_pair(device=None) -> Tuple[dict, dict]:
    """The same scripted crash through the closed loop twice: automated
    TRANSOM detection vs weekend-manual phase costs. Seed-independent."""
    from repro_torch.core.tol.orchestrator import PhaseCosts

    def crash_at(sub, step_at):
        return [(step_at, lambda: _fail_rank(sub, 1, "node_hw"))]

    # automated TRANSOM loop: seconds to detect
    sub_auto = build_substrate(n_nodes=4, n_spares=2, device=device)
    rep_auto, _ = _run_closed_loop(sub_auto, steps=30, ckpt_every=5,
                                   script=crash_at(sub_auto, 12))
    auto = _report_dict("weekend_manual_baseline", 0, sub_auto, rep_auto)
    sub_auto.close()

    # manual-detection baseline: same loop, no TEE, weekend-scale phase costs
    # (paper: 48-72 h before anyone notices a Saturday-night crash)
    sub_man = build_substrate(n_nodes=4, n_spares=2, with_tee=False,
                              device=device)
    manual_costs = PhaseCosts(tee_detect=60 * 3600.0, error_check=1800.0,
                              evict_reschedule=1800.0, inplace_restart=1800.0,
                              warmup=600.0, restore_from_cache=255.0,
                              restore_from_backup=255.0)
    rep_man, _ = _run_closed_loop(sub_man, steps=30, ckpt_every=5,
                                  script=crash_at(sub_man, 12),
                                  costs=manual_costs)
    man = _report_dict("weekend_manual_baseline", 0, sub_man, rep_man)
    sub_man.close()
    return auto, man


@scenario("weekend_manual_baseline",
          "The same crash handled two ways: TRANSOM's automated loop vs "
          "weekend-manual detection; plus the Fig.6-scale DES comparison.")
def _weekend_manual_baseline(seed: int = 0, device=None) -> dict:
    from repro_torch.core.tol.simulate import SimJob, compare

    # the closed-loop half is seed-independent (fixed fault script and
    # substrate seeds); only the DES varies with `seed` — cache it so
    # multi-seed sweeps (fig6) don't rebuild two substrates per seed
    auto, man = _weekend_closed_loop_pair(device)
    auto = dict(auto, seed=seed)
    man = dict(man, seed=seed)

    # months-long discrete-event comparison on the same kernel (Fig. 6)
    des = compare(SimJob(ideal_days=76.0, n_nodes=64, mtbf_node_days=110.0,
                         seed=seed))
    b, t = des["baseline"], des["transom"]
    return {
        "scenario": "weekend_manual_baseline",
        "seed": seed,
        "closed_loop": {
            "transom_downtime_s": auto["recovery"]["total_downtime_s"],
            "manual_downtime_s": man["recovery"]["total_downtime_s"],
            "speedup": round(man["recovery"]["total_downtime_s"]
                             / max(auto["recovery"]["total_downtime_s"], 1e-9), 1),
            "transom": auto,
            "manual": man,
        },
        "des_gpt3_175b": {
            "baseline_days": round(b.end_to_end_days, 2),
            "transom_days": round(t.end_to_end_days, 2),
            "improvement_pct": round(100 * (1 - t.end_to_end_days
                                            / b.end_to_end_days), 1),
            "transom_effective_pct": round(100 * t.effective_frac, 1),
            "transom_mean_restart_min": round(t.mean_restart_s / 60, 1),
        },
        "one_clock": auto["one_clock"] and man["one_clock"],
    }


@scenario("save_racing_crash",
          "A node dies moments after a checkpoint enters the cache, before "
          "persist/backup complete: restore falls back one interval "
          "(bounded-staleness guarantee).")
def _save_racing_crash(seed: int = 0, device=None) -> dict:
    sub = build_substrate(n_nodes=4, n_spares=2, device=device)

    def freeze_pipeline():
        # freeze the durability pipeline after ckpt 5 is durable: the
        # save at step 10 will reach the caches but never persist/backup
        sub.tce.reconciler.quiesce(10)
        sub.tce.reconciler.stop()

    def crash_unpersisted():
        # the crash destroys rank 0's unpersisted cache, then the
        # pipeline resumes for the survivors — ckpt 10 is unrecoverable
        # by construction, so recovery falls back to ckpt 5 (bounded
        # staleness: lost work <= 2 checkpoint intervals)
        sub.tce.caches[0].wipe()
        sub.tce.reconciler.start()
        _fail_rank(sub, 0, "node_hw", quiesce=False)

    report, state = _run_closed_loop(sub, steps=30, ckpt_every=5,
                                     script=[(7, freeze_pipeline),
                                             (11, crash_unpersisted)])
    out = _report_dict("save_racing_crash", seed, sub, report,
                       {"final_w": float(state["w"][0])})
    sub.close()
    return out


# --------------------------------------------------------------------------- #
# Soak presets: time-triggered long-horizon runs on the same substrate
# --------------------------------------------------------------------------- #
@scenario("weeklong_soak",
          "A simulated week of training on 16 nodes under the stochastic "
          "Table-I mix plus cascades and whole-rack outages: faults fire at "
          "timestamps from the EventQueue, not scripted steps.")
def _weeklong_soak(seed: int = 0, device=None) -> dict:
    from .soak import SoakConfig, run_soak

    rep = run_soak(SoakConfig(ideal_days=7.0, n_nodes=16, n_spares=2,
                              mtbf_node_days=30.0, p_cascade=0.25,
                              rack_mtbf_days=90.0, shrink_threshold=0.5),
                   seed=seed)
    return dict(rep, scenario="weeklong_soak")


@scenario("tiered_outage",
          "A week-long soak over the N-tier checkpoint hierarchy with an "
          "adaptive checkpoint cadence: a two-day NAS brownout forces "
          "peer/SSD-tier restores and the rising rollback cost tightens "
          "the cadence (visible as cadence_adapt decisions).")
def _tiered_outage(seed: int = 0, device=None) -> dict:
    from .soak import DAY_S, SoakConfig, run_soak

    rep = run_soak(SoakConfig(ideal_days=7.0, n_nodes=16, n_spares=2,
                              mtbf_node_days=9.0, p_cascade=0.3,
                              rack_mtbf_days=25.0, tiers=True,
                              adaptive_cadence=True,
                              nas_outages=((2 * DAY_S, 2 * DAY_S),)),
                   seed=seed)
    return dict(rep, scenario="tiered_outage")


@scenario("policy_frontier",
          "A quick policy sweep (checkpoint cadence x spare pool) over the "
          "soak engine: TRANSOM vs manual baseline on the same fault "
          "timeline, reporting the best-effective-time frontier.")
def _policy_frontier(seed: int = 0, device=None) -> dict:
    from .sweep import run_sweep

    res = run_sweep("small", seed=seed)
    return {
        "scenario": "policy_frontier",
        "seed": seed,
        "grid": res["grid"],
        "n_points": res["n_points"],
        "frontier": res["frontier"],
        "points": [{"policy": p["policy"],
                    "effective_time_ratio": p["effective_time_ratio"],
                    "lost_steps": p["lost_steps"],
                    "improvement_pct": p["improvement_pct"]}
                   for p in res["points"]],
        "one_clock": all(p["transom"]["one_clock"] and
                         p["baseline"]["one_clock"] for p in res["points"]),
    }


# --------------------------------------------------------------------------- #
# Fleet presets: multi-job scenarios on one shared topology
# --------------------------------------------------------------------------- #
def _register_fleet_presets() -> None:
    """Surface ``repro.fleet`` presets (N jobs, one topology, shared spare
    pool, contended NAS) in this catalog so ``--list``/``--run all`` cover
    the whole fleet. Registration is best-effort: a broken or absent fleet
    package must not take the single-job catalog down with it (the fleet's
    own CLI and CI gates fail loudly on their own)."""
    try:
        from repro_torch.fleet.presets import PRESETS as FLEET_PRESETS
    except ImportError:
        return

    for p in FLEET_PRESETS.values():
        SCENARIOS[p.name] = Scenario(
            p.name, f"[fleet] {p.description}",
            lambda seed, device=None, run=p.run: run(seed))


_register_fleet_presets()


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
def run_scenario(name: str, seed: int = 0, device=None) -> dict:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; have: "
                       f"{', '.join(sorted(SCENARIOS))}")
    from repro_torch.report import finalize
    return finalize(SCENARIOS[name].run(seed, device=device), scenario=name,
                    seed=seed)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.cli import catalog_main
    return catalog_main(
        argv, prog="python -m repro_torch.sim.scenarios",
        description="Run named TEE->TOL->TCE fault scenarios on the unified "
                    "simulation substrate.",
        catalog={n: s.description for n, s in SCENARIOS.items()},
        run=run_scenario, what="scenarios",
        add_args=lambda ap: ap.add_argument(
            "--device", choices=("cuda", "cpu"), default="cuda",
            help="where the TOL burn-ins run (default cuda)"),
        run_kwargs=lambda args: {"device": args.device})


if __name__ == "__main__":
    sys.exit(main())
