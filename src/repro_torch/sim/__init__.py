"""Shared simulation substrate for the TRANSOM closed loop.

One clock, one topology, one fault model: TOL (orchestration), TEE (anomaly
detection) and TCE (checkpointing) all observe the same ``SimClock``, the same
``Topology`` (nodes, spares, failure domains) and the same ``FaultEvent``
taxonomy, so a scenario can never have the subsystems disagree about time,
node health, or what failed.

Layering (no cycles):

    sim.clock      <- nothing
    sim.faults     <- clock
    sim.topology   <- clock, faults
    sim.soak       <- clock, faults, topology (time-triggered soak engine)
    sim.sweep      <- soak, topology (policy sweep harness)
    sim.scenarios  <- everything (builds the full TEE->TOL->TCE stack)
    sim.replay     <- everything (empirical-mix replay over the fleet engine)

``core.tce`` / ``core.tol`` / ``core.tee`` import the kernel, never the other
way around (``sim.scenarios`` is the one top-layer exception: it drives the
core subsystems).
"""
from .clock import EventQueue, SimClock
from .faults import (FAULT_CATEGORIES, MIXES, SIGNATURES, FailureMix,
                     FaultEvent, FaultInjector, cascade_events,
                     correlated_domain_failure, domain_outage_schedule,
                     get_mix, group_domain_incidents, merge_schedules,
                     push_schedule)
from .soak import SoakConfig, SoakPolicy, manual_policy, run_soak, \
    transom_policy
from .topology import Node, NodeState, Topology, nodes_for_fault_rate

__all__ = [
    "SimClock", "EventQueue",
    "FAULT_CATEGORIES", "MIXES", "SIGNATURES", "FailureMix", "FaultEvent",
    "FaultInjector", "cascade_events", "correlated_domain_failure",
    "domain_outage_schedule", "get_mix", "group_domain_incidents",
    "merge_schedules", "push_schedule",
    "SoakConfig", "SoakPolicy", "manual_policy", "run_soak",
    "transom_policy",
    "Node", "NodeState", "Topology", "nodes_for_fault_rate",
]
