"""The shared, cost-aware recovery decision core.

``RecoveryPlanner.plan(incident, cluster) -> RecoveryPlan`` is the ONE place
the detect→triage→shrink-vs-wait→claim→rollback→warmup loop decides what to
do. It is pure and clock-agnostic: everything time-like arrives inside the
:class:`Incident` / :class:`ClusterState` snapshots, nothing here reads a
clock, touches a topology or draws randomness — which is what makes the
decision log deterministic and the planner testable as a golden decision
table.

Candidate actions (the decision table):

===================  ======================================================
``recover_in_place``  no node attributable; restart on the same machines
``claim_spare``       lease a healthy machine from the shared pool
``preempt_donor``     shrink a lower-priority job to free one machine
``shrink``            continue degraded on the survivors (reshard via store)
``wait_for_repair``   stall the recovery until cordoned hardware heals
``regrow``            shrunken job reclaims capacity when a repair lands
``give_up``           nothing else is feasible (job fails)
===================  ======================================================

Every candidate is scored by modelled lost-work + restart cost
(Unicron-style): the rollback the action forces, the restore leg it implies
through the TCE waterfall, and — for ``shrink``/``wait`` — the throughput
lost while degraded or stalled. The *policy* chooses among scored
candidates and is selectable at runtime (Chameleon-style):

* ``"transom"`` — the paper's escalation ladder: claim → preempt → shrink →
  wait; cost scores are logged but the ordering is fixed.
* ``"cost"`` — pure cost minimisation: feasible candidates sorted by score.
* ``"no_shrink"`` — conservative: never run degraded; wait for repairs.

Engines execute plans through :func:`repro.recovery.executor.fill_slots`
and keep only mechanism (claim-ledger leases, restore waterfall, FSM).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from .tiers import (LEGACY_SOURCE_BY_TIER, TIER_DEVICE, TIER_DRAM,
                    TIER_PEER, TierTable, three_leg_tiers)

# -- decision / action names (also the grep-able vocabulary of the log) ---- #
RECOVER_IN_PLACE = "recover_in_place"
CLAIM_SPARE = "claim_spare"
PREEMPT_DONOR = "preempt_donor"
SHRINK = "shrink"
WAIT_FOR_REPAIR = "wait_for_repair"
REGROW = "regrow"
STAY_SHRUNK = "stay_shrunk"
GIVE_UP = "give_up"

PLANNER_POLICIES = ("transom", "cost", "no_shrink")

# below this attribution confidence the planner refuses eviction rungs and
# recovers in place instead (streaming-TEE incidents carry a confidence;
# incidents without one keep the pre-confidence decision table verbatim)
CONFIDENCE_FLOOR = 0.5

# restore sources (the TCE waterfall legs a plan can land on)
SRC_CACHE = "cache"
SRC_BACKUP = "backup"
SRC_STORE = "store_full"

# the classic cache→ring-backup→NAS waterfall as a TierTable; planning
# against it reproduces the historical decision table verbatim
_LEGACY_TABLE = three_leg_tiers()


@dataclass(frozen=True)
class Incident:
    """What happened: one detected anomaly plus its triage facts."""
    kind: str = "fault"               # fault | repair | preemption | retry
    t: float = 0.0                    # modelled seconds at planning time
    victims: Tuple[str, ...] = ()     # attributable bad nodes (empty: none)
    categories: Tuple[str, ...] = ()  # Table-I categories of the victims
    mid_recovery_join: bool = False   # joined an already-open transaction
    ring_adjacent: bool = False       # victims were ring-backup neighbours
    # streaming-TEE attribution confidence in [0, 1]; None = the incident
    # came from a hard signal (process death, hw check), not a detector
    confidence: Optional[float] = None


@dataclass(frozen=True)
class ClusterState:
    """The planner's read-only snapshot of one job's slice of the cluster."""
    n_assigned: int                   # healthy machines still leased
    n_target: int                     # gang size (full strength)
    min_nodes: int                    # elastic floor; >= n_target: no shrink
    free_supply: int = 0              # machines claimable right now
    donor_available: bool = False     # a lower-priority job could donate
    repair_eta_s: Optional[float] = None   # next cordoned repair, if any
    wait_allowed: bool = False        # engine can stall/park this recovery
    has_ring_backup: bool = True
    topology_changed: bool = False    # ring size differs from the checkpoint
    progress_at_risk_s: float = 0.0   # work since the last durable ckpt
    remaining_s: float = float("nan")  # productive work left (NaN: unknown)


@dataclass(frozen=True)
class CostModel:
    """Modelled seconds per recovery phase — the engine's policy costs in
    the planner's vocabulary (one constructor per engine cost type)."""
    error_check_s: float = 90.0
    evict_reschedule_s: float = 360.0
    inplace_restart_s: float = 120.0
    warmup_s: float = 60.0
    restore_cache_s: float = 10.0
    restore_backup_s: float = 16.0
    restore_store_s: float = 255.0
    # N-tier hierarchy legs beyond the classic 3 (device HBM snapshot,
    # rack burst-buffer SSD, cold object store); tier-named sources from
    # choose_restore_plan resolve through these
    restore_device_s: float = 1.0
    restore_ssd_s: float = 30.0
    restore_cold_s: float = 900.0
    # a stalled recovery with no repair ETA is costed at this horizon
    unknown_repair_s: float = 24 * 3600.0
    # confidence-weighted terms (only consulted when the incident carries
    # an attribution confidence): evicting on a wrong attribution wastes a
    # reschedule + cordons a healthy machine; recovering in place on a
    # right one lets the fault recur
    misattribution_s: float = 900.0
    recurrence_s: float = 3600.0

    @classmethod
    def from_soak_policy(cls, pol) -> "CostModel":
        """From a :class:`repro.sim.soak.SoakPolicy`."""
        return cls(error_check_s=pol.error_check_s,
                   evict_reschedule_s=pol.evict_reschedule_s,
                   inplace_restart_s=pol.inplace_restart_s,
                   warmup_s=pol.warmup_s,
                   restore_cache_s=pol.restore_cache_s,
                   restore_backup_s=pol.restore_backup_s,
                   restore_store_s=pol.restore_store_s)

    @classmethod
    def from_phase_costs(cls, costs) -> "CostModel":
        """From the orchestrator's :class:`PhaseCosts` (no store leg there:
        the closed loop's resched restores are ring-backup pulls)."""
        return cls(error_check_s=costs.error_check,
                   evict_reschedule_s=costs.evict_reschedule,
                   inplace_restart_s=costs.inplace_restart,
                   warmup_s=costs.warmup,
                   restore_cache_s=costs.restore_from_cache,
                   restore_backup_s=costs.restore_from_backup,
                   restore_store_s=costs.restore_from_backup)

    def restore_s(self, source: str) -> float:
        """Modelled restore seconds for a waterfall leg — accepts both the
        legacy 3-leg names and the tier names of choose_restore_plan."""
        return {SRC_CACHE: self.restore_cache_s,
                SRC_BACKUP: self.restore_backup_s,
                SRC_STORE: self.restore_store_s,
                "device": self.restore_device_s,
                "dram": self.restore_cache_s,
                "peer": self.restore_backup_s,
                "ssd": self.restore_ssd_s,
                "nas": self.restore_store_s,
                "cold": self.restore_cold_s}[source]


@dataclass(frozen=True)
class Candidate:
    """One scored action from the decision table."""
    action: str
    cost_s: float                     # modelled lost-work + restart cost
    feasible: bool
    reason: str = ""

    def to_entry(self) -> dict:
        cost = None if math.isinf(self.cost_s) or math.isnan(self.cost_s) \
            else round(self.cost_s, 1)
        return {"action": self.action, "cost_s": cost,
                "feasible": self.feasible, "reason": self.reason}


@dataclass(frozen=True)
class RestorePlan:
    """A tier-ranked restore plan: every eligible tier hottest-first.

    ``source`` is the tier the restore should read from; the rest of
    ``tiers`` is the fallback order if that tier turns out empty, and is
    also what a speculative prefetch streams from while TOL is still
    electing/warming replacements."""
    tiers: Tuple[str, ...]
    source: str

    def legacy_source(self) -> str:
        """The 3-leg waterfall name of the chosen tier (decision-log and
        SoakPolicy cost-table vocabulary)."""
        return LEGACY_SOURCE_BY_TIER.get(self.source, SRC_STORE)


@dataclass(frozen=True)
class RecoveryPlan:
    """What the planner decided (policy) for the engine to execute
    (mechanism)."""
    decision: str                     # primary resolving action
    ladder: Tuple[str, ...]           # rung order for fill_slots
    restore_source: str               # expected TCE waterfall leg
    est_cost_s: float                 # score of the primary action
    candidates: Tuple[Candidate, ...]
    entry: dict                       # the JSON-able decision-log record


class DecisionLog:
    """Accumulates deterministic decision records for the run report."""

    def __init__(self):
        self.entries: List[dict] = []
        self.counts: Dict[str, int] = {}

    def record(self, entry: dict) -> None:
        self.entries.append(entry)
        d = entry["decision"]
        self.counts[d] = self.counts.get(d, 0) + 1

    def to_report(self, cap: int = 50) -> dict:
        """JSON-able summary: full counts, log capped deterministically."""
        return {"n": len(self.entries),
                "by_decision": dict(sorted(self.counts.items())),
                "log": self.entries[:cap]}


class RecoveryPlanner:
    """The one recovery brain shared by orchestrator, soak and fleet."""

    def __init__(self, policy: str = "transom",
                 costs: Optional[CostModel] = None,
                 log: Optional[DecisionLog] = None):
        if policy not in PLANNER_POLICIES:
            raise ValueError(f"unknown planner policy {policy!r}; "
                             f"have: {', '.join(PLANNER_POLICIES)}")
        self.policy = policy
        self.costs = costs or CostModel()
        self.log = log or DecisionLog()

    # -- restore-source decision (shared by all engines) ----------------- #
    @staticmethod
    def choose_restore_plan(table: TierTable, *, inplace: bool,
                            escalated: bool, has_ring_backup: bool = True,
                            down: Iterable[str] = ()) -> RestorePlan:
        """Rank the hierarchy's tiers for one restore, hottest first.

        Eligibility per tier (top to bottom of ``table``):

        * a tier named in ``down`` (failed hardware, a brownout, a
          correlated rack loss) is skipped outright;
        * without a ring backup (the manual baseline keeps no volatile
          replicas at all) only durable site-domain tiers qualify;
        * durable tiers always qualify;
        * the peer ring survives the victim node but not an escalated
          transaction (ring-adjacent double death / resize);
        * node-volatile tiers (device HBM, host DRAM) need the process to
          restart *in place* on surviving hardware — and even then an
          escalated transaction invalidates them (ring resize reshards).

        If nothing qualifies the plan falls back to the coldest tier —
        the durable floor of the hierarchy is never unreachable.
        """
        down = set(down)
        ranked = []
        for t in table.tiers:
            if t.name in down:
                continue
            if not has_ring_backup:
                if t.durable and t.failure_domain == "site":
                    ranked.append(t.name)
                continue
            if t.durable:
                ranked.append(t.name)
            elif t.name == TIER_PEER:
                if not escalated:
                    ranked.append(t.name)
            elif t.name in (TIER_DEVICE, TIER_DRAM):
                if inplace and not escalated:
                    ranked.append(t.name)
        if not ranked:
            ranked = [table.coldest().name]
        return RestorePlan(tuple(ranked), ranked[0])

    @staticmethod
    def choose_restore_source(*, inplace: bool, escalated: bool,
                              has_ring_backup: bool = True) -> str:
        """Which TCE waterfall leg a recovery restores through.

        No ring backup (manual baseline): every restore hits the store. An
        escalated transaction — ring-adjacent double death, a fault joining
        mid-restore, or a changed ring size (shrink/grow/preemption
        reshard) — falls through to the full store read, even if it began
        as an in-place restart. Plain in-place restarts read the local
        cache; otherwise the ring backup serves the restore.

        This is the 3-leg view of :meth:`choose_restore_plan`: plan over
        the legacy dram→peer→nas table, map the winning tier back to its
        waterfall name. Engines that model only the classic waterfall keep
        calling this; tiered engines call ``choose_restore_plan`` with
        their own table.
        """
        plan = RecoveryPlanner.choose_restore_plan(
            _LEGACY_TABLE, inplace=inplace, escalated=escalated,
            has_ring_backup=has_ring_backup)
        return plan.legacy_source()

    # -- candidate scoring ------------------------------------------------ #
    def _candidates(self, inc: Incident, st: ClusterState,
                    costs: CostModel) -> List[Candidate]:
        missing = max(st.n_target - st.n_assigned, 0)
        escalated = (inc.mid_recovery_join or inc.ring_adjacent
                     or st.topology_changed)
        full_src = self.choose_restore_source(
            inplace=False, escalated=escalated,
            has_ring_backup=st.has_ring_backup)
        rollback = st.progress_at_risk_s
        restart = costs.evict_reschedule_s + costs.warmup_s
        horizon = st.repair_eta_s if st.repair_eta_s is not None \
            else costs.unknown_repair_s
        out: List[Candidate] = []

        if missing == 0:
            src = self.choose_restore_source(
                inplace=True, escalated=escalated,
                has_ring_backup=st.has_ring_backup)
            out.append(Candidate(
                RECOVER_IN_PLACE, costs.inplace_restart_s
                + costs.restore_s(src) + costs.warmup_s + rollback,
                True, "no machine lost"))
            return out

        # confidence-weighted terms (streaming-TEE incidents only): evicting
        # on a shaky attribution risks cordoning a healthy machine, while
        # restarting in place on a solid one lets the fault recur
        conf = inc.confidence
        evict_tax = (1.0 - conf) * costs.misattribution_s \
            if conf is not None else 0.0
        if conf is not None:
            src = self.choose_restore_source(
                inplace=True, escalated=escalated,
                has_ring_backup=st.has_ring_backup)
            out.append(Candidate(
                RECOVER_IN_PLACE, costs.inplace_restart_s
                + costs.restore_s(src) + costs.warmup_s + rollback
                + conf * costs.recurrence_s,
                True, f"attribution confidence {conf:.2f}"))

        out.append(Candidate(
            CLAIM_SPARE, restart + costs.restore_s(full_src) + rollback
            + evict_tax,
            st.free_supply > 0,
            f"supply {st.free_supply} for {missing} slot(s)"))
        # the donor pays its own forced reshard (rollback through the store)
        donor_penalty = (costs.evict_reschedule_s + costs.restore_store_s
                         + costs.warmup_s)
        out.append(Candidate(
            PREEMPT_DONOR, restart + costs.restore_s(full_src) + rollback
            + donor_penalty + evict_tax,
            st.donor_available, "donor shrinks by one machine"))
        # run degraded on the current survivors: pay a store reshard now,
        # the lost throughput until hardware heals, and the regrow reshard
        # this planner will itself take once the repair lands
        frac = missing / max(st.n_target, 1)
        can_shrink = (st.min_nodes < st.n_target
                      and st.n_assigned >= st.min_nodes)
        regrow_reshard = (costs.evict_reschedule_s + costs.restore_store_s
                          + costs.warmup_s)
        out.append(Candidate(
            SHRINK, costs.restore_store_s + costs.warmup_s + rollback
            + frac * horizon + regrow_reshard,
            can_shrink, f"floor {st.min_nodes}, degraded x{frac:.2f}"))
        can_wait = st.wait_allowed or st.repair_eta_s is not None
        out.append(Candidate(
            WAIT_FOR_REPAIR, horizon + restart
            + costs.restore_s(full_src) + rollback,
            can_wait,
            "repair eta known" if st.repair_eta_s is not None
            else ("recovery can stall" if st.wait_allowed else "")))
        out.append(Candidate(GIVE_UP, float("inf"), True, "last resort"))
        return out

    def _ladder(self, cands: List[Candidate],
                confidence: Optional[float] = None) -> Tuple[str, ...]:
        order = {c.action: i for i, c in enumerate(cands)}
        low_conf = confidence is not None and confidence < CONFIDENCE_FLOOR
        if low_conf:
            # too shaky to evict anybody: restart in place (or stall)
            feasible = [c for c in cands
                        if c.feasible and c.action not in
                        (CLAIM_SPARE, PREEMPT_DONOR, SHRINK, GIVE_UP)]
        else:
            feasible = [c for c in cands
                        if c.feasible and c.action not in (RECOVER_IN_PLACE,
                                                           GIVE_UP)]
        if self.policy == "no_shrink":
            feasible = [c for c in feasible if c.action != SHRINK]
        if self.policy == "cost":
            feasible.sort(key=lambda c: (c.cost_s, order[c.action]))
        return tuple(c.action for c in feasible)

    @staticmethod
    def _decision(ladder: Tuple[str, ...], st: ClusterState) -> str:
        """The first rung that fully resolves the open slots."""
        missing = max(st.n_target - st.n_assigned, 0)
        if missing == 0:
            return RECOVER_IN_PLACE
        if ladder and ladder[0] == RECOVER_IN_PLACE:
            return RECOVER_IN_PLACE     # low-confidence: no eviction
        for rung in ladder:
            if rung == CLAIM_SPARE and st.free_supply >= missing:
                return CLAIM_SPARE
            if rung == PREEMPT_DONOR:
                return PREEMPT_DONOR
            if rung in (SHRINK, WAIT_FOR_REPAIR):
                return rung
        return GIVE_UP

    # -- planning entrypoints --------------------------------------------- #
    def plan(self, incident: Incident, cluster: ClusterState, *,
             costs: Optional[CostModel] = None, job: Optional[str] = None,
             record: bool = True) -> RecoveryPlan:
        """Score the decision table for one incident and pick a plan."""
        cm = costs or self.costs
        cands = self._candidates(incident, cluster, cm)
        ladder = self._ladder(cands, incident.confidence)
        decision = self._decision(ladder, cluster)
        escalated = (incident.mid_recovery_join or incident.ring_adjacent
                     or cluster.topology_changed or decision == SHRINK)
        source = self.choose_restore_source(
            inplace=decision == RECOVER_IN_PLACE, escalated=escalated,
            has_ring_backup=cluster.has_ring_backup)
        by_action = {c.action: c for c in cands}
        primary = by_action.get(decision) \
            or Candidate(decision, float("inf"), True)
        entry = self._entry(incident, cluster, decision, source, cands, job)
        if record:
            self.log.record(entry)
        return RecoveryPlan(decision, ladder, source, primary.cost_s,
                            tuple(cands), entry)

    def plan_regrow(self, cluster: ClusterState, *, t: float = 0.0,
                    costs: Optional[CostModel] = None,
                    job: Optional[str] = None,
                    record: Optional[bool] = None) -> RecoveryPlan:
        """A repair landed (or capacity freed): should a shrunken job pay a
        reshard to regrow? Cost-aware: the rollback + store reshard must be
        cheaper than the throughput still being lost while degraded."""
        cm = costs or self.costs
        st = cluster
        missing = max(st.n_target - st.n_assigned, 0)
        n_after = min(st.n_assigned + st.free_supply, st.n_target)
        reshard = (st.progress_at_risk_s + cm.evict_reschedule_s
                   + cm.restore_store_s + cm.warmup_s)
        if missing == 0 or st.free_supply <= 0 or st.n_assigned <= 0:
            benefit, feasible = 0.0, False
        elif math.isnan(st.remaining_s):
            # remaining work unknown: degradation is open-ended, regrow
            benefit, feasible = float("inf"), True
        else:
            # wall-clock saved over the remaining work by running at
            # n_after/n_target instead of n_assigned/n_target speed
            benefit = st.remaining_s * (st.n_target / st.n_assigned
                                        - st.n_target / n_after)
            feasible = True
        regrow = feasible and benefit > reshard
        decision = REGROW if regrow else STAY_SHRUNK
        cands = (
            Candidate(REGROW, reshard, feasible,
                      f"+{n_after - st.n_assigned} node(s), saves "
                      + ("open-ended" if math.isinf(benefit)
                         else f"{benefit:.0f}s")),
            Candidate(STAY_SHRUNK,
                      0.0 if math.isinf(benefit) else benefit, True,
                      "keep running degraded"),
        )
        incident = Incident(kind="repair", t=t)
        entry = self._entry(incident, cluster, decision, SRC_STORE,
                            list(cands), job)
        if record if record is not None else regrow:
            self.log.record(entry)
        return RecoveryPlan(decision, (REGROW,) if regrow else (),
                            SRC_STORE,
                            reshard if regrow else 0.0, cands, entry)

    # -- log record -------------------------------------------------------- #
    @staticmethod
    def _entry(inc: Incident, st: ClusterState, decision: str, source: str,
               cands: List[Candidate], job: Optional[str]) -> dict:
        entry = {
            "t": round(inc.t, 3),
            "kind": inc.kind,
            "victims": sorted(inc.victims),
            "decision": decision,
            "restore_source": source,
            "n_assigned": st.n_assigned,
            "n_target": st.n_target,
            "free_supply": st.free_supply,
            "candidates": [c.to_entry() for c in cands],
        }
        if inc.confidence is not None:
            entry["confidence"] = round(inc.confidence, 3)
        if job is not None:
            entry["job"] = job
        return entry
