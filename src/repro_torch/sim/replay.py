"""Trace-replay frontend: empirical failure mixes at fleet scale.

Named presets that replay an *empirical* failure distribution — the paper's
Table-I category mix at its measured 110-day node MTBF, or a ByteDance-style
mix (denser hardware/network failures, shorter MTBF; see PAPERS.md) — through
the multi-job fleet engine at three scale points: the paper's 64-node
cluster, a 1k-node pod and a 10k-node fleet, over week-to-month modelled
horizons. The vectorized DES core (batched inter-arrival sampling, array-
backed topology, coalesced event drain) makes the 10k-node / 30-modelled-day
point an interactive run (seconds-to-a-minute wall time; tracked by
``benchmarks/sim_bench.py``).

Presets live in their own registry, **separate** from the fleet scenario
presets in :mod:`repro.fleet.presets` — the CI determinism gate diffs
``python -m repro.fleet --run all`` byte-for-byte, and the 10k replay points
are deliberately too large for that loop (they are exercised by the bench
and the ``slow`` test tier instead).

Layering: like :mod:`repro.sim.scenarios`, this is a top-layer module — it
builds on the fleet engine and may import from ``repro.fleet``.

    python -m repro.sim.replay --list
    python -m repro.sim.replay --run table1_64_week --seed 0
    python -m repro.sim.replay --run bytedance_1k_month --json out.json
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from repro_torch.core.tce.store import NAS_BW_PER_RANK

from .faults import get_mix

# scale points: (total member nodes, concurrent jobs, spare-pool size)
SCALE_POINTS: Dict[str, tuple] = {
    "64": (64, 4, 8),
    "1k": (1024, 16, 32),
    # dense multi-tenancy: hundreds of small jobs on one pod (4 nodes each),
    # the stress case for the streaming TEE's cross-job correlator
    "1k_dense": (1024, 256, 64),
    "10k": (10240, 96, 128),
    # the indexed-dispatch stress point: a full 10k-node fleet packed with
    # 512 twenty-node jobs — per-tick control-plane cost dominates here,
    # which is exactly what the event-driven fleet dispatcher optimizes
    "10k_512": (10240, 512, 128),
}


@dataclass(frozen=True)
class ReplayPreset:
    """One named replay: an empirical mix x a fleet scale x a horizon."""
    name: str
    description: str
    mix: str                     # key into faults.MIXES
    scale: str                   # key into SCALE_POINTS
    ideal_hours: float           # per-job productive compute
    horizon_days: float          # fault-injection horizon
    planner_policy: str = "transom"

    def build(self, seed: int = 0):
        """Materialise the FleetConfig (imported lazily: keep the module
        importable without dragging the whole fleet stack in for --list)."""
        from repro_torch.fleet.engine import FleetConfig
        from repro_torch.fleet.scheduler import JobSpec

        mix = get_mix(self.mix)
        n_nodes, n_jobs, n_spares = SCALE_POINTS[self.scale]
        per_job = n_nodes // n_jobs
        # bigger fleets checkpoint less often per job (paper cadence is per
        # job, not per fleet) and share a wider NAS uplink: scale the shared
        # bandwidth with the job count so aggregate save demand stays in the
        # same contention regime as the 64-node paper cluster
        ckpt_s = 1800.0 if n_nodes <= 64 else (3600.0 if n_nodes <= 1024
                                               else 7200.0)
        jobs = tuple(
            JobSpec(f"job{i:03d}", per_job, priority=i % 3,
                    ideal_hours=self.ideal_hours,
                    min_nodes=max(2, per_job // 2),
                    ckpt_interval_s=ckpt_s)
            for i in range(n_jobs))
        return FleetConfig(
            jobs=jobs, n_nodes=n_nodes, n_spares=n_spares,
            nodes_per_rack=8, racks_per_switch=4, repair_hours=12.0,
            nas_bw_total=max(4, n_jobs // 2) * NAS_BW_PER_RANK,
            mtbf_node_days=mix.mtbf_node_days,
            straggler_frac=mix.straggler_frac,
            p_cascade=mix.p_cascade,
            rack_mtbf_days=mix.rack_mtbf_days,
            horizon_days=self.horizon_days,
            planner_policy=self.planner_policy,
            fault_mix=self.mix, seed=seed)


REPLAY_PRESETS: Dict[str, ReplayPreset] = {}


def _register(p: ReplayPreset) -> None:
    REPLAY_PRESETS[p.name] = p


for _mix in ("table1", "bytedance"):
    _src = get_mix(_mix).source
    _register(ReplayPreset(
        f"{_mix}_64_week",
        f"Paper-scale 64-node cluster, 4 jobs, ~1 modelled week under the "
        f"{_src} failure mix.",
        mix=_mix, scale="64", ideal_hours=150.0, horizon_days=10.0))
    _register(ReplayPreset(
        f"{_mix}_1k_month",
        f"1k-node pod, 16 jobs, ~1 modelled month under the {_src} "
        f"failure mix.",
        mix=_mix, scale="1k", ideal_hours=600.0, horizon_days=40.0))
    _register(ReplayPreset(
        f"{_mix}_10k_month",
        f"10k-node fleet, 96 jobs, ~1 modelled month under the {_src} "
        f"failure mix (the interactive-scale DES point).",
        mix=_mix, scale="10k", ideal_hours=600.0, horizon_days=40.0))

_register(ReplayPreset(
    "1k_nodes_256_jobs_month",
    "Dense multi-tenancy: 1k-node pod packed with 256 four-node jobs for "
    "~1 modelled month under the paper's Table-I mix — the hundreds-of-jobs "
    "stress point for fleet-wide streaming TEE scoring.",
    mix="table1", scale="1k_dense", ideal_hours=600.0, horizon_days=40.0))

_register(ReplayPreset(
    "10k_nodes_512_jobs_month",
    "Fleet-control-plane stress point: a 10k-node fleet running 512 "
    "twenty-node jobs for ~1 modelled month under the paper's Table-I mix. "
    "Interactive only under the indexed event dispatcher (wakeup heaps, "
    "vectorized progress banking); CI gates its wall time in "
    "BENCH_fleet.json.",
    mix="table1", scale="10k_512", ideal_hours=600.0, horizon_days=40.0))


def run_replay(name: str, seed: int = 0,
               planner_policy: Optional[str] = None) -> dict:
    """Run one replay preset; returns its deterministic JSON report
    annotated with the preset and mix provenance. ``planner_policy``
    overrides the preset's RecoveryPlanner policy (transom/cost/no_shrink)."""
    from dataclasses import replace as _dc_replace

    from repro_torch.fleet.engine import run_fleet

    if name not in REPLAY_PRESETS:
        raise KeyError(f"unknown replay preset {name!r}; have: "
                       f"{', '.join(sorted(REPLAY_PRESETS))}")
    preset = REPLAY_PRESETS[name]
    if planner_policy is not None:
        preset = _dc_replace(preset, planner_policy=planner_policy)
    mix = get_mix(preset.mix)
    from repro_torch.report import finalize

    rep = run_fleet(preset.build(seed), seed=seed)
    return finalize(dict(
        rep, replay=name,
        mix={"name": mix.name, "source": mix.source,
             "weights": dict(mix.weights),
             "mtbf_node_days": mix.mtbf_node_days,
             "rack_mtbf_days": mix.rack_mtbf_days},
        scale=preset.scale,
        planner_policy=preset.planner_policy), scenario=name, seed=seed)


def preset_names() -> List[str]:
    return sorted(REPLAY_PRESETS)


def main(argv: Optional[List[str]] = None) -> int:
    from repro_torch.cli import catalog_main

    def summarize(rep: dict) -> dict:
        return {
            "replay": rep["replay"], "scale": rep["scale"],
            "makespan_days": rep["makespan_days"],
            "utilization": rep["fleet"]["utilization"],
            "faults_injected": rep["faults"]["injected"],
            "faults_hit_jobs": rep["faults"]["hit_jobs"],
        }

    return catalog_main(
        argv, prog="python -m repro_torch.sim.replay",
        description="Replay empirical failure mixes through the fleet "
                    "engine at 64 / 1k / 10k-node scale.",
        catalog={n: p.description for n, p in REPLAY_PRESETS.items()},
        run=run_replay, what="replay presets",
        add_args=lambda ap: ap.add_argument(
            "--planner", choices=("transom", "cost", "no_shrink"),
            default=None, help="override the planner policy"),
        run_kwargs=lambda args: {"planner_policy": args.planner},
        summarize=summarize)


if __name__ == "__main__":
    sys.exit(main())
