"""Cluster view for the scheduler — now a thin facade over the shared
simulation kernel (``repro.sim``).

Historically this module kept its *own* node/fault model, separate from the
fabric's ``_down`` set in TCE and the fault taxonomy in TEE; those three could
silently disagree mid-scenario. The node model, fault events and injector all
live in ``repro.sim.topology`` / ``repro.sim.faults`` now; this module only
re-exports them under their established names.

``ClusterSim`` *is* the shared :class:`repro.sim.topology.Topology` — the
scheduler (TOL), the fabric (TCE) and the scenario engine all read and write
the same instance.
"""
from __future__ import annotations

from repro_torch.sim.faults import (FAULT_CATEGORIES, FaultEvent,  # noqa: F401
                              FaultInjector)
from repro_torch.sim.topology import Node, NodeState, Topology  # noqa: F401

# Name kept for the existing tests/benchmarks/examples; same class, no shim.
ClusterSim = Topology

__all__ = ["ClusterSim", "Topology", "Node", "NodeState",
           "FaultEvent", "FaultInjector", "FAULT_CATEGORIES"]
