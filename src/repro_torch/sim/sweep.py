"""Policy sweep harness: TRANSOM vs manual baseline over a policy grid.

Runs the time-triggered soak engine (``repro.sim.soak``) over a grid of
``(checkpoint_cadence, spare_pool_size, shrink_threshold, fault_rate)`` and
emits a deterministic JSON matrix of effective-training-time ratio, lost
steps and restore-source mix — the paper's Fig. 6 "TRANSOM vs manual
baseline" comparison computed as a sweep instead of a hardcoded scenario.
Grids may add ``planner_policy`` (transom/cost/no_shrink RecoveryPlanner
policies) and ``fault_mix`` (empirical category mixes from
:data:`repro.sim.faults.MIXES`) axes; the ``month_1k`` / ``month_10k`` grids
cross both at pod / fleet scale over a 30-day modelled horizon.

The ``fault_rate`` axis is in cluster-wide faults/week; it is turned into a
concrete fleet via :func:`repro.sim.topology.nodes_for_fault_rate` (MTBF-
scaled node counts), so both policies at a grid point face the *same*
seeded fault timeline and differ only in detection/checkpoint/restore
policy. The baseline keeps its own fixed 3-hourly synchronous cadence —
sweeping the cadence is exactly the knob TRANSOM makes cheap.

Usage:

    python -m repro.sim.sweep --grid default --seed 0
    python -m repro.sim.sweep --grid default --seed 0 --json sweep.json

Output is byte-identical across runs with the same seed (enforced in CI).
"""
from __future__ import annotations

import itertools
import sys
from dataclasses import replace
from typing import Dict, List, Optional

from .soak import SoakConfig, manual_policy, run_soak, transom_policy
from .topology import nodes_for_fault_rate

# grid axes: checkpoint cadence (s), spare pool size, shrink threshold
# (min surviving fraction; 0 = never shrink, wait for repairs), fault rate
# (cluster faults/week -> MTBF-scaled node count at the env's per-node MTBF)
GRIDS: Dict[str, Dict[str, list]] = {
    "default": {
        "ckpt_cadence_s": [900.0, 1800.0, 3600.0, 10800.0],
        "spare_pool": [0, 2, 8],
        "shrink_threshold": [0.0, 0.5],
        "fault_rate_per_week": [1.0, 3.5],
    },
    "small": {
        "ckpt_cadence_s": [1800.0, 10800.0],
        "spare_pool": [0, 4],
        "shrink_threshold": [0.5],
        "fault_rate_per_week": [2.0],
    },
    # the paper's Fig. 6 cluster: 64 nodes (512 A800s) at 110 d node MTBF
    # -> 64 * 7 / 110 faults/week, ideal compute 76 days
    "fig6": {
        "ckpt_cadence_s": [900.0, 1800.0, 3600.0],
        "spare_pool": [2, 8],
        "shrink_threshold": [0.0],
        "fault_rate_per_week": [64 * 7 / 110.0],
    },
    # month-horizon replay grids at pod / fleet scale: the planner_policy
    # and fault_mix axes cross the RecoveryPlanner's decision policies with
    # the empirical failure mixes (Table I vs ByteDance-style); the node
    # count comes from the mix's MTBF via the fault-rate axis as usual
    "month_1k": {
        "ckpt_cadence_s": [3600.0],
        "spare_pool": [32],
        "shrink_threshold": [0.5],
        "fault_rate_per_week": [1024 * 7 / 110.0],
        "planner_policy": ["transom", "cost", "no_shrink"],
        "fault_mix": ["table1", "bytedance"],
    },
    "month_10k": {
        "ckpt_cadence_s": [7200.0],
        "spare_pool": [128],
        "shrink_threshold": [0.5],
        "fault_rate_per_week": [10240 * 7 / 110.0],
        "planner_policy": ["transom", "cost", "no_shrink"],
        "fault_mix": ["table1", "bytedance"],
    },
}

_GRID_IDEAL_DAYS = {"default": 7.0, "small": 7.0, "fig6": 76.0,
                    "month_1k": 30.0, "month_10k": 30.0}


def run_point(ckpt_cadence_s: float, spare_pool: int,
              shrink_threshold: float, fault_rate_per_week: float,
              seed: int = 0, ideal_days: float = 7.0,
              mtbf_node_days: float = 110.0,
              planner_policy: str = "transom",
              fault_mix: str = "table1") -> dict:
    """One grid point: soak the same fault environment under the TRANSOM
    policy (at the swept cadence) and the manual baseline. ``planner_policy``
    selects the RecoveryPlanner's decision policy and ``fault_mix`` the
    empirical category mix; both apply to the pair, so the A/B still isolates
    detection/checkpoint/restore policy."""
    n_nodes = nodes_for_fault_rate(fault_rate_per_week, mtbf_node_days)
    cfg = SoakConfig(ideal_days=ideal_days, n_nodes=n_nodes,
                     n_spares=spare_pool, mtbf_node_days=mtbf_node_days,
                     shrink_threshold=shrink_threshold,
                     rack_mtbf_days=365.0,
                     planner_policy=planner_policy, fault_mix=fault_mix,
                     policy=transom_policy(ckpt_cadence_s), seed=seed)
    transom = run_soak(cfg)
    baseline = run_soak(replace(cfg, policy=manual_policy()))
    for rep in (transom, baseline):
        # keep the planner's decision *counts* per point; the full entry
        # log (5 scored candidates per decision) belongs to standalone soak
        # reports — embedded verbatim across a 48-point grid it would bloat
        # the committed bench baselines by thousands of lines
        rep["decisions"] = {k: v for k, v in rep["decisions"].items()
                            if k != "log"}
    t_days, b_days = transom["end_to_end_days"], baseline["end_to_end_days"]
    return {
        "policy": {
            "ckpt_cadence_s": ckpt_cadence_s,
            "spare_pool": spare_pool,
            "shrink_threshold": shrink_threshold,
            "fault_rate_per_week": round(fault_rate_per_week, 4),
            "planner_policy": planner_policy,
            "fault_mix": fault_mix,
            "n_nodes": n_nodes,
        },
        "transom": transom,
        "baseline": baseline,
        "effective_time_ratio": transom["effective_time_ratio"],
        "lost_steps": transom["lost_steps"],
        "improvement_pct": round(100.0 * (1.0 - t_days / b_days), 2),
        "speedup": round(b_days / t_days, 3),
    }


def run_sweep(grid: str = "default", seed: int = 0,
              ideal_days: Optional[float] = None) -> dict:
    """Sweep the grid; returns the deterministic JSON matrix plus, per fault
    rate, the frontier point (best effective-training-time ratio)."""
    if grid not in GRIDS:
        raise KeyError(f"unknown grid {grid!r}; have: "
                       f"{', '.join(sorted(GRIDS))}")
    spec = GRIDS[grid]
    ideal = _GRID_IDEAL_DAYS[grid] if ideal_days is None else ideal_days
    points: List[dict] = []
    for cadence, spares, thr, rate, planner, mix in itertools.product(
            spec["ckpt_cadence_s"], spec["spare_pool"],
            spec["shrink_threshold"], spec["fault_rate_per_week"],
            spec.get("planner_policy", ["transom"]),
            spec.get("fault_mix", ["table1"])):
        points.append(run_point(cadence, spares, thr, rate, seed=seed,
                                ideal_days=ideal, planner_policy=planner,
                                fault_mix=mix))
    frontier = {}
    for rate in spec["fault_rate_per_week"]:
        cands = [p for p in points
                 if p["policy"]["fault_rate_per_week"] == round(rate, 4)]
        best = max(cands, key=lambda p: (p["effective_time_ratio"],
                                         -p["policy"]["ckpt_cadence_s"]))
        frontier[f"{rate:g}_per_week"] = {
            "policy": best["policy"],
            "effective_time_ratio": best["effective_time_ratio"],
            "improvement_pct": best["improvement_pct"],
        }
    from repro_torch.report import finalize

    return finalize({
        "engine": "sweep",
        "grid": grid,
        "seed": seed,
        "ideal_days": ideal,
        "axes": spec,
        "n_points": len(points),
        "points": points,
        "frontier": frontier,
    }, scenario=grid, seed=seed)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.cli import base_parser, list_catalog, write_reports

    ap = base_parser(
        prog="python -m repro_torch.sim.sweep",
        description="Policy sweep (TRANSOM vs manual baseline) over the "
                    "time-triggered soak engine.")
    ap.add_argument("--grid", default="default", choices=sorted(GRIDS))
    ap.add_argument("--ideal-days", type=float, default=None,
                    help="override the grid's ideal compute days")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the stdout table")
    args = ap.parse_args(argv)

    if args.list:
        return list_catalog(
            {g: f"{len(GRIDS[g])} axes" for g in GRIDS},
            prog="python -m repro_torch.sim.sweep", what="sweep grids",
            hint="python -m repro_torch.sim.sweep --grid <name>")

    res = run_sweep(args.grid, seed=args.seed, ideal_days=args.ideal_days)
    if not args.quiet:
        print(f"grid={res['grid']} seed={res['seed']} "
              f"points={res['n_points']} ideal_days={res['ideal_days']}")
        print(f"{'cadence_s':>10} {'spares':>6} {'shrink':>6} {'rate/wk':>8} "
              f"{'planner':>9} {'mix':>9} "
              f"{'eff_ratio':>9} {'lost_steps':>10} {'improve%':>8}")
        for p in res["points"]:
            pol = p["policy"]
            print(f"{pol['ckpt_cadence_s']:>10.0f} {pol['spare_pool']:>6d} "
                  f"{pol['shrink_threshold']:>6.2f} "
                  f"{pol['fault_rate_per_week']:>8.2f} "
                  f"{pol['planner_policy']:>9} {pol['fault_mix']:>9} "
                  f"{p['effective_time_ratio']:>9.4f} "
                  f"{p['lost_steps']:>10d} {p['improvement_pct']:>8.2f}")
        for rate, f in sorted(res["frontier"].items()):
            print(f"frontier @ {rate}: cadence="
                  f"{f['policy']['ckpt_cadence_s']:.0f}s "
                  f"spares={f['policy']['spare_pool']} "
                  f"eff={f['effective_time_ratio']:.4f} "
                  f"improve={f['improvement_pct']:.2f}%")
    write_reports([res], json_path=args.json, out_dir=args.out,
                  name_key="grid")
    return 0


if __name__ == "__main__":
    sys.exit(main())
