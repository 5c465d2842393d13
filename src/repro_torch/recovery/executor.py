"""The small executor protocol between the planner and the engines.

The planner decides (policy); engines act (mechanism). ``fill_slots`` is
the shared control flow that walks a plan's escalation ladder over an
engine's mechanism callbacks until every open replacement slot is resolved:

* ``try_claim``   — lease one machine through the Topology claim ledger;
* ``try_preempt`` — ask the scheduler to name + shrink a donor job;
* ``do_shrink``   — commit to running degraded (the survivors reshard);
* ``do_wait``     — stall until repairs land. Returns ``True`` when the
  engine actually waited (blocking engines: retry the ladder), ``False``
  when it cannot wait (nothing repairing), or ``None`` when the engine
  *parks* the recovery instead of blocking (the fleet DES moves the job to
  its WAITING state and re-enters the ladder on the next repair event).

Because cluster state moves underneath a recovery (faults absorbed during
waits, repairs landing, other jobs claiming), ``fill_slots`` re-plans from
a fresh :class:`~repro.recovery.planner.ClusterState` snapshot on every
iteration; only decision *changes* are recorded, so the log stays small and
deterministic.
"""
from __future__ import annotations

from typing import Callable, Optional

from .planner import (CLAIM_SPARE, PREEMPT_DONOR, SHRINK, WAIT_FOR_REPAIR,
                      ClusterState, CostModel, Incident, RecoveryPlanner)

# terminal outcomes of one fill_slots run
FILLED = "filled"          # every slot replaced at full strength
SHRUNK = "shrunk"          # committed to running degraded
WAITING = "waiting"        # recovery parked until capacity appears
GAVE_UP = "gave_up"        # no feasible rung left


class RecoveryExecutor:
    """Mechanism callbacks for one engine's open recovery transaction."""

    def __init__(self, *, missing: Callable[[], int],
                 try_claim: Callable[[], bool],
                 try_preempt: Optional[Callable[[], bool]] = None,
                 do_shrink: Optional[Callable[[], None]] = None,
                 do_wait: Optional[Callable[[], Optional[bool]]] = None):
        self.missing = missing
        self.try_claim = try_claim
        self.try_preempt = try_preempt or (lambda: False)
        self.do_shrink = do_shrink or (lambda: None)
        self.do_wait = do_wait or (lambda: False)


def fill_slots(planner: RecoveryPlanner, incident: Incident,
               state_fn: Callable[[], ClusterState],
               executor: RecoveryExecutor, *,
               costs: Optional[CostModel] = None,
               job: Optional[str] = None, record: bool = True) -> str:
    """Resolve an open recovery's replacement slots down the planned ladder.

    Returns one of ``filled`` / ``shrunk`` / ``waiting`` / ``gave_up``.
    With ``record=False`` nothing is logged (event-driven engines re-enter
    the ladder on every tick while a recovery is parked; those no-op
    retries must not flood the decision log).
    """
    last_decision: Optional[str] = None
    claim_blocked = False   # a claim failed against a stale supply snapshot
    while executor.missing() > 0:
        plan = planner.plan(incident, state_fn(), costs=costs, job=job,
                            record=False)
        if record and plan.decision != last_decision:
            planner.log.record(plan.entry)
        last_decision = plan.decision
        acted = False
        for rung in plan.ladder:
            if rung == CLAIM_SPARE:
                if not claim_blocked and executor.try_claim():
                    acted = True
                    break
                claim_blocked = True
            elif rung == PREEMPT_DONOR:
                if executor.try_preempt():
                    acted = True
                    break
            elif rung == SHRINK:
                executor.do_shrink()
                return SHRUNK
            elif rung == WAIT_FOR_REPAIR:
                waited = executor.do_wait()
                if waited is None:
                    return WAITING
                if waited:
                    claim_blocked = False   # repairs may have refilled supply
                    acted = True
                    break
        if not acted:
            return GAVE_UP
    return FILLED
