"""Fleet control plane: N concurrent training jobs on one shared topology.

Public surface:

* :class:`~repro.fleet.scheduler.JobSpec` /
  :class:`~repro.fleet.scheduler.FleetScheduler` — gang scheduling, pending
  queue, priorities, preemption donors;
* :class:`~repro.fleet.view.JobView` — a per-job ClusterSim-compatible lens
  over the shared :class:`~repro.sim.topology.Topology` (claim-arbitrated
  replacements);
* :class:`~repro.fleet.engine.FleetConfig` /
  :func:`~repro.fleet.engine.run_fleet` — the multi-job discrete-event
  engine (shared clock, shared spare pool, contended NAS bandwidth);
* :mod:`repro.fleet.presets` — named fleet scenarios
  (``python -m repro.fleet --list``).
"""
from .engine import FleetConfig, no_preemption, run_fleet  # noqa: F401
from .presets import PRESETS, preset_names, run_preset  # noqa: F401
from .scheduler import FleetScheduler, JobSpec  # noqa: F401
from .view import JobView  # noqa: F401

__all__ = ["FleetConfig", "FleetScheduler", "JobSpec", "JobView",
           "PRESETS", "no_preemption", "preset_names", "run_fleet",
           "run_preset"]
