"""The port's copy of the shared simulation kernel (``repro.sim`` is the
reference): one clock, one topology, one fault model for the control plane.

Layering (no cycles):

    sim.clock      <- nothing
    sim.faults     <- clock
    sim.topology   <- clock, faults

The three modules are copies of the reference's, imports aside. The soak
engine, the policy sweep, the scenario catalog and the trace replay that the
reference's package also holds wait for a later slice of the port.
"""
from .clock import EventQueue, SimClock
from .faults import (FAULT_CATEGORIES, MIXES, SIGNATURES, FailureMix,
                     FaultEvent, FaultInjector, cascade_events,
                     correlated_domain_failure, domain_outage_schedule,
                     get_mix, group_domain_incidents, merge_schedules,
                     push_schedule)
from .topology import Node, NodeState, Topology, nodes_for_fault_rate

__all__ = [
    "SimClock", "EventQueue",
    "FAULT_CATEGORIES", "MIXES", "SIGNATURES", "FailureMix", "FaultEvent",
    "FaultInjector", "cascade_events", "correlated_domain_failure",
    "domain_outage_schedule", "get_mix", "group_domain_incidents",
    "merge_schedules", "push_schedule",
    "Node", "NodeState", "Topology", "nodes_for_fault_rate",
]
