"""One recovery brain: the shared, cost-aware RecoveryPlanner.

TRANSOM's core claim (paper §IV-A) is that the *automatic* fault-tolerance
strategy — not ad-hoc per-engine logic — decides how a task recovers. This
package is that strategy, extracted into a pure, clock-agnostic decision
core used by all three engines:

* the closed-loop orchestrator (:mod:`repro.core.tol.orchestrator`),
* the time-triggered soak engine (:mod:`repro.sim.soak`),
* the multi-job fleet engine (:mod:`repro.fleet.engine`).

The planner owns the decision table — recover-in-place vs claim-spare vs
preempt-donor vs shrink vs wait-for-repair, plus regrow-on-repair — scores
candidate actions by modelled lost-work + restart cost (Unicron-style), and
emits a structured, deterministic decision log that lands in every
scenario/soak/fleet JSON report. Engines keep only mechanism: leases via the
Topology claim ledger, the TCE restore waterfall, FSM transitions.

The policy itself is selectable at runtime (Chameleon-style): ``"transom"``
(the paper's escalation ladder), ``"cost"`` (pure cost minimisation over the
same candidates) and ``"no_shrink"`` (never run degraded; wait for repairs).
"""
from .cadence import CADENCE_ADAPT, CadenceController  # noqa: F401
from .executor import RecoveryExecutor, fill_slots  # noqa: F401
from .planner import (CLAIM_SPARE, GIVE_UP, PLANNER_POLICIES,  # noqa: F401
                      PREEMPT_DONOR, RECOVER_IN_PLACE, REGROW, SHRINK,
                      SRC_BACKUP, SRC_CACHE, SRC_STORE, STAY_SHRUNK,
                      WAIT_FOR_REPAIR, Candidate, ClusterState, CostModel,
                      DecisionLog, Incident, RecoveryPlan, RecoveryPlanner,
                      RestorePlan)
from .tiers import (LEGACY_SOURCE_BY_TIER, TIER_COLD,  # noqa: F401
                    TIER_DEVICE, TIER_DRAM, TIER_NAS, TIER_PEER, TIER_SSD,
                    Tier, TierTable, default_tiers, three_leg_tiers,
                    tiers_down_for)

__all__ = [
    "Candidate", "ClusterState", "CostModel", "DecisionLog", "Incident",
    "RecoveryExecutor", "RecoveryPlan", "RecoveryPlanner", "RestorePlan",
    "fill_slots",
    "PLANNER_POLICIES", "RECOVER_IN_PLACE", "CLAIM_SPARE", "PREEMPT_DONOR",
    "SHRINK", "WAIT_FOR_REPAIR", "REGROW", "STAY_SHRUNK", "GIVE_UP",
    "SRC_CACHE", "SRC_BACKUP", "SRC_STORE",
    "Tier", "TierTable", "default_tiers", "three_leg_tiers",
    "tiers_down_for", "LEGACY_SOURCE_BY_TIER",
    "TIER_DEVICE", "TIER_DRAM", "TIER_PEER", "TIER_SSD", "TIER_NAS",
    "TIER_COLD",
    "CadenceController", "CADENCE_ADAPT",
]
