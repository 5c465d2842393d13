"""Fleet engine: N concurrent training jobs on ONE shared substrate.

Every run builds exactly one :class:`~repro.sim.clock.SimClock`, one
:class:`~repro.sim.topology.Topology` and one fault
:class:`~repro.sim.clock.EventQueue`; N modelled training jobs (the soak
engine's cost model, per job) advance on that single timeline:

* the :class:`~repro.fleet.scheduler.FleetScheduler` gang-schedules jobs,
  queues the ones that don't fit, and arbitrates every replacement claim
  through the topology's lease ledger — two recovering jobs can never be
  handed the same spare;
* a low-priority job can be **preempted**: elastically shrunk by one machine
  to unblock a high-priority job's recovery when the shared pool is dry
  (the donor pays a reshard — rollback to its last durable checkpoint and a
  restore through the store);
* checkpoint saves and store restores are **flows on one shared NAS**
  (:class:`~repro.core.tce.store.SharedBandwidth`, processor sharing): one
  job's restore waterfall visibly slows another job's async save, and a
  save that hasn't drained when a crash lands is torn (not durable);
* correlated faults carry their failure-domain tag, so a rack/switch outage
  hits every co-located job in the same event (reported per ``(t, domain)``
  group) and replacements avoid the failed domain.

The run is fully seeded and emits a deterministic JSON-able report with
per-job recovery/goodput sections and fleet-level utilization.
"""
from __future__ import annotations

import heapq
import math
import time
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.tce.store import NAS_BW_PER_RANK, SharedBandwidth
from repro_torch.recovery import (RECOVER_IN_PLACE, REGROW, SRC_CACHE, SRC_STORE,
                            ClusterState, CostModel, Incident,
                            RecoveryExecutor, RecoveryPlanner, fill_slots)
from repro_torch.recovery.executor import WAITING as PLAN_WAITING
from repro_torch.sim.clock import EventQueue, SimClock
from repro_torch.sim.faults import (FaultEvent, FaultInjector, cascade_events,
                              domain_outage_schedule, get_mix,
                              group_domain_incidents, merge_schedules,
                              push_schedule)
from repro_torch.sim.soak import DAY_S, NODE_ATTRIBUTABLE, SoakPolicy
from repro_torch.sim.topology import NodeState, Topology
from repro_torch.tee_stream import (CrossJobCorrelator, FleetStreamTEE,
                              StreamObservation)

from .scheduler import FleetScheduler, JobSpec

_EPS = 1e-6

# job lifecycle states; DETECT/RESCHEDULE/RESTORE/WARMUP are the phases of
# one open recovery transaction
PENDING, RUNNING, STALLED = "pending", "running", "stalled"
DETECT, RESCHEDULE, RESTORE, WARMUP = ("detect", "reschedule", "restore",
                                       "warmup")
WAITING, DONE = "waiting", "done"
_RECOVERY = frozenset({DETECT, RESCHEDULE, RESTORE, WARMUP, WAITING})

# states with no timed deadline: excluded from the wakeup heap (RUNNING jobs
# wake on progress markers instead; WAITING jobs wake on repairs)
_UNTIMED = (PENDING, RUNNING, WAITING, DONE)

# process-wide overrides consumed by :func:`run_fleet` — they let the CLI
# (``--profile``) and the equivalence suite flip behaviour underneath preset
# functions that build their own FleetConfig
_FORCE_LEGACY = False       # run every fleet under the legacy dispatcher
_PROFILE = False            # attach a ``measured`` phase-time breakdown


def set_force_legacy(flag: bool) -> None:
    """Force ``legacy_dispatch=True`` on every subsequent :func:`run_fleet`
    (the equivalence suite's hook under preset functions)."""
    global _FORCE_LEGACY
    _FORCE_LEGACY = bool(flag)


def set_profile(flag: bool) -> None:
    """Attach a ``measured`` section (wall time, tick count, per-phase
    breakdown) to every subsequent :func:`run_fleet` report. The simulation
    itself is unchanged — reports stay byte-identical sans ``measured``."""
    global _PROFILE
    _PROFILE = bool(flag)


@dataclass(frozen=True)
class FleetConfig:
    """One fleet run: a shared cluster, N job specs, a fault environment."""
    jobs: Tuple[JobSpec, ...]
    n_nodes: int = 16
    n_spares: int = 4
    nodes_per_rack: int = 8
    racks_per_switch: int = 4
    repair_hours: float = 4.0
    # one shared NAS uplink (paper §IV-C per-rank bandwidth x a few ranks):
    # an 8 GB checkpoint drains in ~28 s solo, ~56 s with one contender
    nas_bw_total: float = 4 * NAS_BW_PER_RANK
    preemption: bool = True
    # stochastic fault environment (0 disables each source)
    mtbf_node_days: float = 0.0
    straggler_frac: float = 0.15
    p_cascade: float = 0.0
    cascade_window_s: float = 600.0
    rack_mtbf_days: float = 0.0
    horizon_days: float = 30.0
    scripted: Tuple[FaultEvent, ...] = ()        # deterministic extra events
    planner_policy: str = "transom"              # RecoveryPlanner policy
    fault_mix: str = "table1"                    # category mix (faults.MIXES)
    # streaming TEE (Eagle Eye): degradation faults are detected by scoring
    # the affected jobs' metric streams (vectorized, confidence-weighted,
    # cross-job correlated by failure domain) instead of firing instantly
    tee_stream: bool = False
    tee_correlation_s: float = 900.0             # domain correlation window
    # N-tier checkpoint hierarchy knobs (repro.recovery.tiers):
    # ``restore_prefetch`` speculatively streams the store checkpoint on the
    # shared NAS while a job is still rescheduling, so the restore leg only
    # pays the residual; ``tier_correlated`` models the peer-ring backup tier
    # sharing the rack failure domain — a rack outage takes the ring with it
    # and the recovery escalates straight to the durable store tiers
    restore_prefetch: bool = False
    tier_correlated: bool = False
    # background TieredStore demotions on the shared NAS: scripted
    # ``(t_s, nbytes)`` flows modelling capacity-driven step aging
    # (``TieredStore.demote_due``) contending with foreground saves/restores
    demotion_traffic: Tuple[Tuple[float, float], ...] = ()
    # A/B switch: run the poll-everything control loop that predates the
    # indexed dispatcher (scans every job on every wakeup). Reports are
    # byte-identical between the two paths (pinned in
    # tests/test_fleet_dispatch.py); only wall time differs.
    legacy_dispatch: bool = False
    seed: int = 0


class _Job:
    """Runtime state of one job (spec + progress + open-recovery fields).

    ``done`` (productive seconds banked) is array-backed: the value lives in
    the run's shared numpy vector at this job's ``idx``, so the indexed
    dispatcher can advance every running job's progress in one vectorized
    operation while per-job handlers keep reading/writing ``job.done`` as a
    plain float (same IEEE-double arithmetic either way).
    """

    def __init__(self, spec: JobSpec, idx: int, done_arr: np.ndarray):
        self.spec = spec
        self.idx = idx
        self._done_arr = done_arr
        self.pol: SoakPolicy = spec.policy
        self.state = PENDING
        self.until = math.inf            # end of the current timed phase
        self.need = spec.ideal_hours * 3600.0
        self.last_ckpt = 0.0             # durable checkpoint (productive s)
        self.next_ckpt = spec.ckpt_interval_s
        self.save_flow: Optional[Tuple[int, float]] = None   # (fid, snapshot)
        self.restore_flow: Optional[int] = None
        self.prefetch_flow: Optional[int] = None  # speculative store stream
        self.prefetch_done = False
        # open recovery transaction
        self.inplace = False
        self.escalate = False
        self.recovery_t0 = 0.0
        self.pending_replace = 0
        self.wait_start = 0.0
        self.wait_s_in_open = 0.0
        self.restore_src = SRC_CACHE
        self.victim_racks: List[str] = []
        # lifetime stats
        self.admitted_at = math.inf
        self.finished_at = math.inf
        self.final_nodes = 0
        self.lost_s = 0.0
        self.restart_times: List[float] = []
        self.downtime_s = 0.0
        self.restore_sources: Dict[str, int] = {}
        self.counts = dict(faults_hit=0, absorbed=0, domain_hits=0,
                           shrinks=0, regrows=0, donations_given=0,
                           donations_taken=0, waits=0, saves_started=0,
                           saves_durable=0, saves_torn=0, saves_skipped=0,
                           prefetch_started=0, prefetch_hits=0)
        self.wait_s = 0.0
        self._done_counted = False       # _FleetRun._n_done accounting
        # CostModel view of this job's policy for the shared planner
        self.cost_model = CostModel.from_soak_policy(self.pol)

    @property
    def done(self) -> float:
        return float(self._done_arr[self.idx])

    @done.setter
    def done(self, v: float) -> None:
        self._done_arr[self.idx] = v

    @property
    def active(self) -> bool:
        return self.state not in (PENDING, DONE)

    def rate(self, view) -> float:
        return len(view.assigned) / self.spec.n_nodes


class _FleetRun:
    def __init__(self, cfg: FleetConfig, seed: int):
        self.cfg = cfg
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.clock = SimClock()
        self.topo = Topology(cfg.n_nodes, n_spares=cfg.n_spares,
                             repair_hours=cfg.repair_hours,
                             nodes_per_rack=cfg.nodes_per_rack,
                             racks_per_switch=cfg.racks_per_switch,
                             clock=self.clock, auto_assign=False)
        self.sched = FleetScheduler(self.topo)
        self.nas = SharedBandwidth(cfg.nas_bw_total)
        self.events = EventQueue(self.clock)
        self.jobs: Dict[str, _Job] = {}
        self.specs: Dict[str, JobSpec] = {}
        # vectorized per-job progress state (see _Job.done): one slot per
        # job in spec order == jobs-dict insertion order
        n = len(cfg.jobs)
        self._done_arr = np.zeros(n)
        self._rate_arr = np.zeros(n)
        self._running_arr = np.zeros(n, dtype=bool)
        self._marker_arr = np.full(n, math.inf)
        for idx, spec in enumerate(cfg.jobs):
            if spec.n_nodes > cfg.n_nodes:
                raise ValueError(f"{spec.name}: wants {spec.n_nodes} nodes, "
                                 f"fleet has {cfg.n_nodes}")
            self.specs[spec.name] = spec
            self.jobs[spec.name] = _Job(spec, idx, self._done_arr)
            if spec.submit_at_s > 0:
                self.events.push(spec.submit_at_s, ("submit", spec.name))
        self._by_idx: List[_Job] = list(self.jobs.values())
        # -- indexed-dispatch state (maintained in both modes; only the
        # indexed loop reads it) ---------------------------------------- #
        # per-job generation counters: every _touch bumps a job's gen, so
        # heap entries carrying an older gen are dropped lazily on pop
        self._gen = [0] * n
        self._until_heap: List[Tuple[float, int, int]] = []   # (until, i, g)
        self._pending_set: Set[int] = set(range(n))   # every job starts PENDING
        self._waiting_set: Set[int] = set()
        self._shrunk_set: Set[int] = set()
        self._zero_rate: Set[int] = set()
        self._n_done = 0
        self._newly_admitted: List[str] = []
        # NAS flow index: fid -> owning job (replaces the all-jobs scan in
        # _nas_completions); plus background demotion flows, which no job
        # owns
        self._flow_owner: Dict[int, _Job] = {}
        self._demote_fids: Set[int] = set()
        # arbiter next-completion cache, keyed on (rate-change epoch,
        # virtual time): valid until a flow starts/cancels/completes or the
        # arbiter's piecewise drain advances
        self._nas_cache_key: Optional[Tuple[int, float]] = None
        self._nas_cache_val: Optional[float] = None
        self._legacy = cfg.legacy_dispatch
        self._ticks = 0
        self._wall_s = 0.0
        self._prof: Optional[Dict[str, float]] = None
        for t_d, nbytes in cfg.demotion_traffic:
            self.events.push(float(t_d), ("demote", float(nbytes)))
        schedule: List[FaultEvent] = list(cfg.scripted)
        weights = (None if cfg.fault_mix == "table1"
                   else dict(get_mix(cfg.fault_mix).weights))
        if cfg.mtbf_node_days > 0:
            primary = FaultInjector(
                cfg.n_nodes, cfg.mtbf_node_days,
                horizon_days=cfg.horizon_days,
                straggler_frac=cfg.straggler_frac, seed=seed,
                weights=weights).schedule()
            if cfg.p_cascade > 0:
                primary = cascade_events(
                    primary, list(self.topo.nodes), p_cascade=cfg.p_cascade,
                    recovery_window_s=cfg.cascade_window_s, seed=seed + 1,
                    weights=weights)
            schedule = merge_schedules(schedule, primary)
        if cfg.rack_mtbf_days > 0:
            schedule = merge_schedules(schedule, domain_outage_schedule(
                self.topo, "rack", cfg.rack_mtbf_days, cfg.horizon_days,
                seed=seed + 2))
        self.n_injected = push_schedule(self.events, schedule)
        # ONE recovery brain across every job: claim-vs-preempt-vs-shrink-
        # vs-wait and regrow-on-repair are planned here, per-job costs
        # supplied per call; the engine below is mechanism only
        self.planner = RecoveryPlanner(cfg.planner_policy)
        self.counts = dict(idle_faults=0, job_faults=0, preemptions=0,
                           demotions_started=0, demotions_drained=0)
        # (t, domain) -> set of job names hit by that correlated event
        self.correlated: Dict[Tuple[float, str], Set[str]] = {}
        # streaming TEE service + cross-job correlator (Eagle Eye)
        self.tee: Optional[FleetStreamTEE] = None
        self.tee_correlator: Optional[CrossJobCorrelator] = None
        self.tee_incidents: List[dict] = []
        if cfg.tee_stream:
            self.tee = FleetStreamTEE(seed=seed)
            self.tee_correlator = CrossJobCorrelator(cfg.tee_correlation_s)

    # ------------------------------------------------------------------ #
    def _view(self, job: _Job):
        return self.sched.views[job.spec.name]

    def _detect_s(self, pol: SoakPolicy) -> float:
        if pol.weekend_frac > 0 and self.rng.random() < pol.weekend_frac:
            return pol.weekend_detect_s
        return float(self.rng.exponential(pol.detect_mean_s))

    def _next_repair(self) -> Optional[float]:
        # O(1): the array-backed topology caches its min repair deadline
        due = self.topo.next_repair_at()
        if due is None:
            return None
        return max(due, self.clock.seconds + 1.0)

    # -- indexed-dispatch bookkeeping ----------------------------------- #
    def _touch(self, job: _Job) -> None:
        """Refresh every index the dispatcher keeps for ``job``: the rate /
        running / marker vectors, the pending/waiting/shrunk/zero-rate dirty
        sets, the done counter, and (lazily, via a bumped generation) its
        wakeup-heap entry. Called by every handler that mutates a job's
        state, phase deadline, assignment or checkpoint marker. Inert under
        legacy dispatch — the poll loop rescans instead, keeping its cost
        profile honest for the A/B."""
        if self._legacy:
            return
        i = job.idx
        self._gen[i] += 1
        st = job.state
        view = self.sched.views.get(job.spec.name)
        r = len(view.assigned) / job.spec.n_nodes if view is not None else 0.0
        running = st == RUNNING
        self._rate_arr[i] = r
        self._running_arr[i] = running
        self._marker_arr[i] = min(job.next_ckpt, job.need)
        (self._pending_set.add if st == PENDING
         else self._pending_set.discard)(i)
        (self._waiting_set.add if st == WAITING
         else self._waiting_set.discard)(i)
        shrunk = (running and view is not None
                  and len(view.assigned) < job.spec.n_nodes)
        (self._shrunk_set.add if shrunk else self._shrunk_set.discard)(i)
        (self._zero_rate.add if running and r <= 0.0
         else self._zero_rate.discard)(i)
        if st == DONE and not job._done_counted:
            job._done_counted = True
            self._n_done += 1
        if job.until < math.inf and st not in _UNTIMED:
            heapq.heappush(self._until_heap, (job.until, i, self._gen[i]))

    def _nas_start(self, t: float, nbytes: float, label: str,
                   job: _Job) -> int:
        fid = self.nas.start(t, nbytes, label)
        self._flow_owner[fid] = job
        return fid

    def _nas_cancel(self, fid: int) -> None:
        self.nas.cancel(fid)
        self._flow_owner.pop(fid, None)

    def _nas_next(self) -> Optional[float]:
        """Cached ``SharedBandwidth.next_completion``: the prediction is
        recomputed only when the arbiter's rate-change epoch (a flow
        started/cancelled/completed) or its piecewise virtual time moved —
        otherwise the flow set and shares are unchanged and the cached
        completion time is still exact."""
        key = (self.nas.epoch, self.nas.virtual_time)
        if key != self._nas_cache_key:
            self._nas_cache_key = key
            self._nas_cache_val = self.nas.next_completion()
        return self._nas_cache_val

    def _activate(self, job: _Job, t: float) -> None:
        if job.state == PENDING:
            job.state = RUNNING
            job.admitted_at = t
            job.next_ckpt = job.spec.ckpt_interval_s
            self._touch(job)

    def _try_admit(self, t: float) -> None:
        for spec in self.sched.try_admit():
            self._activate(self.jobs[spec.name], t)
        # jobs admitted by a mid-dispatch scheduler.submit() call (submit
        # events) activate here, on the same _process pass as before
        while self._newly_admitted:
            self._activate(self.jobs[self._newly_admitted.pop(0)], t)

    # -- recovery transaction ------------------------------------------- #
    def _open_recovery(self, job: _Job, t: float, victims: List[str],
                       inplace: bool,
                       detect_s: Optional[float] = None) -> None:
        """Open one recovery transaction. ``detect_s`` overrides the drawn
        detection time — streaming-TEE incidents already paid detection on
        the metric stream, so they open with ``detect_s=0.0``."""
        if job.save_flow is not None:
            # the crash tears the in-flight save: it never becomes durable
            self._nas_cancel(job.save_flow[0])
            job.save_flow = None
            job.counts["saves_torn"] += 1
        job.state = DETECT
        job.inplace = inplace
        job.escalate = False
        job.recovery_t0 = t
        job.pending_replace = 0
        job.wait_s_in_open = 0.0
        job.victim_racks = []
        if detect_s is None:
            detect_s = self._detect_s(job.pol)
        job.until = t + detect_s + job.pol.error_check_s
        self._evict_and_note(job, t, victims)

    def _evict_and_note(self, job: _Job, t: float,
                        victims: List[str]) -> None:
        view = self._view(job)
        for v in victims:
            job.victim_racks.append(self.topo.domain_of(v))
            view.evict(v, t)
            job.pending_replace += 1
        self._touch(job)

    def _avoid_domains(self, job: _Job) -> Set[str]:
        # 2+ victims in one rack point at a correlated root cause: keep
        # replacements out of that failure domain (domain-tagged events
        # already recorded each victim's rack here too)
        hits: Dict[str, int] = {}
        for r in job.victim_racks:
            hits[r] = hits.get(r, 0) + 1
        return {r for r, c in hits.items() if c >= 2}

    def _find_donor(self, spec) -> Optional[str]:
        """Mechanism: the scheduler names the lowest-priority shrinkable job
        among those not currently mid-recovery."""
        if not self.cfg.preemption:
            return None
        donatable = {n for n, j in self.jobs.items()
                     if j.state in (RUNNING, STALLED)}
        return self.sched.find_donor(spec, self.specs, donatable)

    def _claim_replacements(self, job: _Job, t: float,
                            retrying: bool = False) -> None:
        """Fill this recovery's open slots — *mechanism only*; the
        claim-vs-preempt-vs-shrink-vs-wait ladder is the shared
        RecoveryPlanner's. Leaves the job in RESCHEDULE or WAITING.
        ``retrying`` marks a re-attempt from the WAITING state (wait
        bookkeeping continues instead of restarting)."""
        spec, view = job.spec, self._view(job)
        avoid = self._avoid_domains(job)

        def _cstate() -> ClusterState:
            eta = self._next_repair()
            return ClusterState(
                n_assigned=len(view.assigned),
                n_target=len(view.assigned) + job.pending_replace,
                min_nodes=spec.min_nodes,
                free_supply=self.topo.claimable_supply(),
                donor_available=self._find_donor(spec) is not None,
                repair_eta_s=max(eta - t, 0.0) if eta is not None else None,
                wait_allowed=True,
                has_ring_backup=job.pol.has_ring_backup,
                topology_changed=job.escalate,
                progress_at_risk_s=job.done - job.last_ckpt,
                remaining_s=job.need - job.done)

        def _claim() -> bool:
            got = self.sched.claim_replacement(spec.name, set(), avoid)
            if got is None:
                return False
            job.pending_replace -= 1
            return True

        def _preempt() -> bool:
            donor = self._find_donor(spec)
            if donor is None:
                return False
            self.sched.donate(donor, spec.name)
            self._preempt_donor(self.jobs[donor], t)
            job.counts["donations_taken"] += 1
            self.counts["preemptions"] += 1
            job.pending_replace -= 1
            return True

        def _shrink() -> None:
            # run shrunk: the survivors reshard from the store
            job.counts["shrinks"] += 1
            job.escalate = True
            job.pending_replace = 0

        # a parked recovery re-enters this ladder on every tick; scan supply
        # and donors once here for the log gate (fill_slots' per-iteration
        # _cstate re-scan stays — claims consume supply mid-fill) and only
        # log the retries that can actually move
        record = not retrying or self.topo.claimable_supply() > 0 \
            or self._find_donor(spec) is not None
        outcome = fill_slots(
            self.planner,
            Incident("retry" if retrying else "fault", t,
                     mid_recovery_join=job.escalate),
            _cstate,
            RecoveryExecutor(missing=lambda: job.pending_replace,
                             try_claim=_claim, try_preempt=_preempt,
                             do_shrink=_shrink, do_wait=lambda: None),
            costs=job.cost_model, job=spec.name, record=record)
        if outcome == PLAN_WAITING:
            # below the elastic floor and the pool is dry: stall the
            # recovery until repairs land (or a donor frees up)
            job.state = WAITING
            job.until = math.inf
            if not retrying:
                job.wait_start = t
                job.counts["waits"] += 1
            self._touch(job)
            return
        if retrying:
            job.wait_s += t - job.wait_start
            job.wait_s_in_open += t - job.wait_start
        job.state = RESCHEDULE
        job.until = t + job.pol.evict_reschedule_s
        self._maybe_prefetch(job, t)
        self._touch(job)

    def _maybe_prefetch(self, job: _Job, t: float) -> None:
        """Speculative restore prefetch: while the job sits in its
        reschedule window (slot filling, rank rebinding), start streaming
        the full store checkpoint on the shared NAS so the restore leg only
        pays whatever hasn't drained yet. Only fired when the planner's tier
        ranking already points at the store — prefetching a cache or
        ring-backup restore would burn shared bandwidth for nothing."""
        if not self.cfg.restore_prefetch or job.prefetch_flow is not None \
                or job.prefetch_done:
            return
        src = self.planner.choose_restore_source(
            inplace=job.inplace, escalated=job.escalate,
            has_ring_backup=job.pol.has_ring_backup)
        if src != SRC_STORE:
            return
        job.counts["prefetch_started"] += 1
        job.prefetch_flow = self._nas_start(
            t, job.spec.ckpt_bytes, f"{job.spec.name}:prefetch", job)

    def _open_planned_reshard(self, job: _Job, t: float) -> None:
        """A planned topology change (preemption donation or regrow): roll
        back to the last durable checkpoint and reshard through the store.
        No detect phase — nothing failed."""
        if job.save_flow is not None:
            self._nas_cancel(job.save_flow[0])
            job.save_flow = None
            job.counts["saves_torn"] += 1
        job.state = RESCHEDULE
        job.inplace = False
        job.escalate = True                 # reshard == store restore
        job.recovery_t0 = t
        job.pending_replace = 0
        job.wait_s_in_open = 0.0
        job.victim_racks = []
        job.until = t + job.pol.evict_reschedule_s
        self._maybe_prefetch(job, t)
        self._touch(job)

    def _preempt_donor(self, donor: _Job, t: float) -> None:
        """The donor lost a machine to a higher-priority job."""
        donor.counts["donations_given"] += 1
        self._open_planned_reshard(donor, t)

    def _maybe_regrow(self, t: float, shrunk: List[_Job]) -> None:
        """Repairs landed or capacity freed: shrunken RUNNING jobs reclaim
        machines, highest priority first, whenever the planner scores the
        reshard (rollback + store restore) cheaper than the throughput still
        being lost while degraded. This is the regrow-on-repair rung fleet
        jobs historically never took (they stayed shrunk for life).
        ``shrunk`` comes from the caller: the legacy loop rescans every job,
        the indexed loop reads its maintained shrunk set — same candidates
        either way (the sort below fixes the order)."""
        for job in sorted(shrunk,
                          key=lambda j: (-j.spec.priority,
                                         self.sched.submit_order(
                                             j.spec.name))):
            spec, view = job.spec, self._view(job)
            supply = self.topo.claimable_supply()
            if supply <= 0:
                return
            plan = self.planner.plan_regrow(
                ClusterState(
                    n_assigned=len(view.assigned), n_target=spec.n_nodes,
                    min_nodes=spec.min_nodes, free_supply=supply,
                    progress_at_risk_s=job.done - job.last_ckpt,
                    remaining_s=job.need - job.done),
                t=t, costs=job.cost_model, job=spec.name)
            if plan.decision != REGROW:
                continue
            got = 0
            while len(view.assigned) < spec.n_nodes and \
                    self.sched.claim_replacement(spec.name, set(), ()) \
                    is not None:
                got += 1
            if got:
                job.counts["regrows"] += 1
                self._open_planned_reshard(job, t)

    def _start_restore(self, job: _Job, t: float) -> None:
        job.state = RESTORE
        pol = job.pol
        # which TCE waterfall leg serves this restore is the planner's call
        job.restore_src = self.planner.choose_restore_source(
            inplace=job.inplace, escalated=job.escalate,
            has_ring_backup=pol.has_ring_backup)
        if job.restore_src != SRC_STORE and job.prefetch_flow is not None:
            # misprediction (the plan improved while rescheduling): drop
            # the speculative stream, the bytes were never needed
            self._nas_cancel(job.prefetch_flow)
            job.prefetch_flow = None
        if job.restore_src == SRC_STORE:
            if job.prefetch_done:
                # the speculative stream fully drained during the
                # reschedule window: the restore leg is free
                job.prefetch_done = False
                job.counts["prefetch_hits"] += 1
                job.until = t
            elif job.prefetch_flow is not None:
                # adopt the in-flight speculative stream as the restore
                # flow: only the residual bytes remain to drain
                job.restore_flow = job.prefetch_flow
                job.prefetch_flow = None
                job.counts["prefetch_hits"] += 1
                job.until = math.inf
            else:
                # reshard / double-fault / no-ring-backup policy: the
                # restore pulls the full checkpoint through the shared NAS
                # (a flow that contends with every other job's saves and
                # restores)
                job.until = math.inf    # ends when the NAS flow drains
                job.restore_flow = self._nas_start(
                    t, job.spec.ckpt_bytes, f"{job.spec.name}:restore", job)
        elif job.restore_src == SRC_CACHE:
            job.until = t + pol.inplace_restart_s + pol.restore_cache_s
        else:
            job.until = t + pol.restore_backup_s
        self._touch(job)

    def _close_recovery(self, job: _Job, t: float) -> None:
        view = self._view(job)
        src = job.restore_src
        job.restore_sources[src] = job.restore_sources.get(src, 0) + 1
        job.lost_s += job.done - job.last_ckpt
        job.done = job.last_ckpt
        job.next_ckpt = job.done + job.spec.ckpt_interval_s
        view.rebind_ranks(list(view.assigned))
        job.restart_times.append(t - job.recovery_t0 - job.wait_s_in_open)
        job.downtime_s += t - job.recovery_t0
        if job.prefetch_flow is not None:       # never adopted: stale
            self._nas_cancel(job.prefetch_flow)
            job.prefetch_flow = None
        job.prefetch_done = False
        job.state = RUNNING
        job.until = math.inf
        self._touch(job)

    # -- fault dispatch -------------------------------------------------- #
    def _handle_incident(self, t: float, evs: List[FaultEvent]) -> None:
        """Dispatch one incident: a single fault, or the member events of a
        same-(t, domain) correlated outage coalesced by
        :func:`group_domain_incidents`. Members are processed in the queue's
        stable FIFO order, exactly as a one-at-a-time drain would (pinned by
        test): the first member hitting each running job opens its recovery,
        the rest join that open transaction and escalate it to the store
        path."""
        if self.tee is not None:
            # Eagle Eye: degradations (slow, not dead) are only visible in
            # the metric streams — divert them to the streaming TEE; hard
            # crashes keep the immediate path (the gang scheduler sees the
            # process die, no detector needed)
            streamed = [ev for ev in evs if self._streamable(ev)]
            evs = [ev for ev in evs if not self._streamable(ev)]
            if streamed:
                self._observe_stream(t, streamed)
        for ev in evs:
            self._handle_fault(t, ev)

    # -- streaming-TEE path (Eagle Eye) ----------------------------------- #
    def _streamable(self, ev: FaultEvent) -> bool:
        """Degradation on a node a running job owns: detectable only by
        watching that job's metric stream."""
        if not ev.degrades_only:
            return False
        node = self.topo.nodes.get(ev.node)
        owner = self.topo.owner_of(ev.node)
        if node is None or owner is None or owner not in self.jobs \
                or node.state not in (NodeState.HEALTHY, NodeState.DEGRADED):
            return False
        return self.jobs[owner].state in (RUNNING, STALLED)

    def _observe_stream(self, t: float, evs: List[FaultEvent]) -> None:
        """Score the affected jobs' streams in one vectorized pass; firing
        verdicts enter the cross-job correlator, which groups them by
        failure domain and schedules one flush per domain group."""
        obs: List[StreamObservation] = []
        seen: Set[str] = set()
        for ev in evs:
            owner = self.topo.owner_of(ev.node)
            job = self.jobs[owner]
            if ev.domain is not None:
                job.counts["domain_hits"] += 1
                self.correlated.setdefault((t, ev.domain), set()).add(owner)
            if owner in seen:
                continue              # one stream per job per incident
            seen.add(owner)
            view = self._view(job)
            assigned = list(view.assigned)
            rank = assigned.index(ev.node) if ev.node in assigned else 0
            obs.append(StreamObservation(
                job=owner, n_ranks=len(assigned), rank=rank, node=ev.node,
                domain=ev.domain or self.topo.domain_of(ev.node),
                category=ev.category, degrades_only=True))
        for anom in self.tee.observe(t, obs):
            deadline = self.tee_correlator.add(anom)
            if deadline is not None:
                self.events.push(deadline, ("tee_flush", anom.domain))

    def _handle_tee_flush(self, t: float, domain: str) -> None:
        """A domain correlation window closed: plan ONCE for the whole
        domain-level incident (confidence-weighted), then execute per
        affected job."""
        inc = self.tee_correlator.flush(domain)
        if inc is None:
            return
        live = [n for n in inc.jobs
                if self.jobs[n].state in (RUNNING, STALLED)]
        owned = {n: [v for v in inc.victims if self.topo.owner_of(v) == n]
                 for n in live}
        pinc = Incident(kind="tee", t=t, victims=inc.victims,
                        categories=inc.categories, confidence=inc.confidence)
        if not live:
            self.tee_incidents.append(self._tee_entry(inc, "no_live_job"))
            return
        # one confidence-weighted plan for the domain (first job's view
        # stands in for the gang; per-job slot filling stays mechanism)
        job0 = self.jobs[live[0]]
        view0 = self._view(job0)
        eta = self._next_repair()
        st = ClusterState(
            n_assigned=len(view0.assigned) - len(owned[live[0]]),
            n_target=len(view0.assigned),
            min_nodes=job0.spec.min_nodes,
            free_supply=self.topo.claimable_supply(),
            donor_available=self._find_donor(job0.spec) is not None,
            repair_eta_s=max(eta - t, 0.0) if eta is not None else None,
            wait_allowed=True,
            has_ring_backup=job0.pol.has_ring_backup,
            progress_at_risk_s=job0.done - job0.last_ckpt,
            remaining_s=job0.need - job0.done)
        plan = self.planner.plan(pinc, st, costs=job0.cost_model,
                                 job="+".join(live))
        evict = plan.decision != RECOVER_IN_PLACE
        for name in live:
            job = self.jobs[name]
            victims = owned[name]
            if evict:
                for v in victims:     # cordon now: attribution is trusted
                    node = self.topo.nodes[v]
                    node.state = NodeState.DEGRADED
                    node.fail_category = inc.categories[0]
                    node.repair_at = t + self.topo.repair_s
            self.counts["job_faults"] += 1
            job.counts["faults_hit"] += 1
            # detection was already paid on the stream (flush fires after
            # the firing window closed): no extra drawn detect time
            self._open_recovery(job, t, victims if evict else [],
                                inplace=not evict, detect_s=0.0)
        self.tee_incidents.append(self._tee_entry(inc, plan.decision))

    @staticmethod
    def _tee_entry(inc, decision: str) -> dict:
        return {"t_open": round(inc.t_open, 3), "domain": inc.domain,
                "jobs": list(inc.jobs), "victims": list(inc.victims),
                "confidence": inc.confidence,
                "n_anomalies": inc.n_anomalies,
                "categories": list(inc.categories),
                "decision": decision}

    def _handle_fault(self, t: float, ev: FaultEvent) -> None:
        node = self.topo.nodes.get(ev.node)
        owner = self.topo.owner_of(ev.node)
        if node is None or owner is None or owner not in self.jobs \
                or node.state not in (NodeState.HEALTHY, NodeState.DEGRADED):
            self.counts["idle_faults"] += 1
            return
        job = self.jobs[owner]
        if not job.active:
            self.counts["idle_faults"] += 1
            return
        attributable = (ev.degrades_only or ev.domain is not None
                        or ev.category in NODE_ATTRIBUTABLE)
        if attributable:
            node.state = (NodeState.DEGRADED if ev.degrades_only
                          else NodeState.FAILED)
            node.fail_category = ev.category
            node.repair_at = t + self.topo.repair_s
        if ev.domain is not None:
            job.counts["domain_hits"] += 1
            self.correlated.setdefault((t, ev.domain), set()).add(owner)
        # tier-correlated outage: the peer-ring backups live in the same
        # rack failure domain as the victims, so a domain-tagged event takes
        # the ring tier down with the nodes — escalate straight to the
        # durable store tiers
        tier_corr = self.cfg.tier_correlated and ev.domain is not None
        victims = [ev.node] if attributable else []
        if job.state in (RUNNING, STALLED):
            self.counts["job_faults"] += 1
            job.counts["faults_hit"] += 1
            self._open_recovery(job, t, victims, inplace=not attributable)
            if tier_corr:
                job.escalate = True
        else:                                   # lands in an open recovery
            job.counts["absorbed"] += 1
            if tier_corr:
                job.escalate = True
            if not attributable:
                return
            self._evict_and_note(job, t, victims)
            job.escalate = True                 # double fault -> store path
            if job.state == DETECT:
                return                          # handled when checks finish
            if job.state == RESTORE and job.restore_flow is not None:
                self._nas_cancel(job.restore_flow)
                job.restore_flow = None
            if job.state == WAITING:
                return                          # retried on the next repair
            self._claim_replacements(job, t)

    # -- timed-phase transitions ----------------------------------------- #
    def _advance_phase(self, job: _Job, t: float) -> None:
        if job.state == STALLED:
            job.state = RUNNING
            job.until = math.inf
            self._touch(job)
        elif job.state == DETECT:
            if job.inplace:
                self._start_restore(job, t)   # no eviction: restart in place
            else:
                self._claim_replacements(job, t)
        elif job.state == RESCHEDULE:
            self._start_restore(job, t)
        elif job.state == RESTORE:          # fixed-cost restore finished
            job.state = WARMUP
            job.until = t + job.pol.warmup_s
            self._touch(job)
        elif job.state == WARMUP:
            self._close_recovery(job, t)

    def _retry_waiting(self, job: _Job, t: float) -> None:
        """Re-run the whole escalation ladder for a stalled recovery: a
        repaired machine, a freed spare or a donor back in RUNNING state can
        all unblock it (the preemption rung stays live while waiting)."""
        self._claim_replacements(job, t, retrying=True)

    # -- progress markers -------------------------------------------------- #
    def _marker(self, job: _Job) -> float:
        return min(job.next_ckpt, job.need)

    def _at_marker(self, job: _Job, t: float) -> None:
        spec = job.spec
        if job.done >= job.need - _EPS:
            job.state = DONE
            job.finished_at = t
            job.final_nodes = len(self._view(job).assigned)
            job.until = math.inf
            if job.save_flow is not None:
                self._nas_cancel(job.save_flow[0])
                job.save_flow = None
            self._touch(job)
            self.sched.complete(spec.name)
            self._try_admit(t)
            return
        if job.done >= job.next_ckpt - _EPS:
            if job.save_flow is not None:
                # previous async save still draining (NAS contention):
                # skip this cadence tick rather than stacking flows
                job.counts["saves_skipped"] += 1
                job.next_ckpt = job.done + spec.ckpt_interval_s
                self._touch(job)
                return
            job.counts["saves_started"] += 1
            job.save_flow = (self._nas_start(t, spec.ckpt_bytes,
                                             f"{spec.name}:save", job),
                             job.done)
            job.next_ckpt = job.done + spec.ckpt_interval_s
            job.state = STALLED
            job.until = t + job.pol.ckpt_save_stall_s
            self._touch(job)

    # -- NAS flow completions --------------------------------------------- #
    def _nas_completions(self, t: float) -> None:
        """Indexed flow-completion dispatch: every drained fid goes straight
        to its owning job via ``_flow_owner`` instead of the all-jobs scan
        the legacy loop still runs. Background demotion flows (TieredStore
        step aging on the shared NAS) have no owning job."""
        for t_done, fid, _label in self.nas.take_completed(t):
            if fid in self._demote_fids:
                self._demote_fids.discard(fid)
                self.counts["demotions_drained"] += 1
                continue
            job = self._flow_owner.pop(fid, None)
            if job is None:
                continue
            if job.save_flow is not None and job.save_flow[0] == fid:
                job.last_ckpt = job.save_flow[1]
                job.save_flow = None
                job.counts["saves_durable"] += 1
            elif job.restore_flow == fid:
                job.restore_flow = None
                job.state = WARMUP
                job.until = t_done + job.pol.warmup_s
                self._touch(job)
            elif job.prefetch_flow == fid:
                # speculative stream drained before the restore leg
                # opened: the bytes are staged, the restore will be free
                job.prefetch_flow = None
                job.prefetch_done = True

    def _nas_completions_legacy(self, t: float) -> None:
        for t_done, fid, _label in self.nas.take_completed(t):
            if fid in self._demote_fids:
                self._demote_fids.discard(fid)
                self.counts["demotions_drained"] += 1
                continue
            self._flow_owner.pop(fid, None)
            for job in self.jobs.values():
                if job.save_flow is not None and job.save_flow[0] == fid:
                    job.last_ckpt = job.save_flow[1]
                    job.save_flow = None
                    job.counts["saves_durable"] += 1
                    break
                if job.restore_flow == fid:
                    job.restore_flow = None
                    job.state = WARMUP
                    job.until = t_done + job.pol.warmup_s
                    break
                if job.prefetch_flow == fid:
                    # speculative stream drained before the restore leg
                    # opened: the bytes are staged, the restore will be free
                    job.prefetch_flow = None
                    job.prefetch_done = True
                    break

    # -- main loop --------------------------------------------------------- #
    def run(self) -> dict:
        t0 = time.perf_counter()
        for spec in self.cfg.jobs:
            if spec.submit_at_s <= 0:
                if self.sched.submit(spec) is not None:
                    self._newly_admitted.append(spec.name)
        self._try_admit(0.0)
        if self.cfg.legacy_dispatch:
            self._run_legacy()
        else:
            self._run_indexed()
        self._wall_s = time.perf_counter() - t0
        return self._report()

    def _run_indexed(self) -> None:
        """Event-driven dispatch: O(1) done-count termination, the next
        deadline from the wakeup heap / marker vector / epoch-cached NAS
        predictor, and vectorized progress banking between control events.
        Produces the exact tick sequence (and so the exact report) of
        :meth:`_run_legacy`; only the per-tick cost differs."""
        n_jobs = len(self._by_idx)
        prof = self._prof
        guard = 0
        while self._n_done < n_jobs:
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("fleet loop did not converge")
            self._ticks += 1
            if prof is not None:
                tp = time.perf_counter()
            t_now = self.clock.seconds
            t_next = max(self._next_deadline(t_now), t_now)
            dt = t_next - t_now
            if dt > 0.0:
                # identical IEEE arithmetic to the legacy per-job loop:
                # done[i] += dt * rate[i], running jobs only
                np.add(self._done_arr, dt * self._rate_arr,
                       out=self._done_arr, where=self._running_arr)
            if prof is not None:
                prof["deadline_bank"] += time.perf_counter() - tp
            self.clock.advance_to(t_next)
            self._process(t_next)

    def _next_deadline(self, t_now: float) -> float:
        """Minimum over exactly the candidate deadlines the legacy scan
        collects, without the per-job Python loop: event-queue head, cached
        NAS completion, wakeup-heap top (timed recovery phases), one
        vectorized pass over running jobs' progress markers, and the repair
        bound whenever any job is pending/waiting/shrunk/starved."""
        cands: List[float] = []
        if self.events:
            cands.append(self.events.peek_time())
        nc = self._nas_next()
        if nc is not None:
            cands.append(nc)
        h = self._until_heap
        while h:
            until, i, g = h[0]
            if g != self._gen[i]:
                heapq.heappop(h)        # stale: the job was touched since
                continue
            cands.append(until)
            break
        # markers re-derive the exact legacy expression each tick (an
        # anchored fire-time pushed at touch-time would be ulps away from
        # the freshly-computed candidate and break the byte-identical tick
        # sequence); one numpy pass instead of a per-job Python loop
        m = self._running_arr & (self._rate_arr > 0.0)
        if m.any():
            fire = t_now + np.maximum(
                self._marker_arr[m] - self._done_arr[m], 0.0) \
                / self._rate_arr[m]
            cands.append(float(fire.min()))
        if (self._pending_set or self._waiting_set or self._shrunk_set
                or self._zero_rate):
            # a queued, parked, shrunken or starved job wakes on repairs
            nr = self._next_repair()
            if nr is not None:
                cands.append(nr)
        if not cands:
            raise RuntimeError(
                "fleet deadlock: no runnable job, no pending event "
                f"(states: {[j.state for j in self.jobs.values()]})")
        return min(cands)

    def _advance_due(self, t: float) -> None:
        """Pop every timed job whose deadline fired and advance it in
        job-index order — the same order (and the same lazy condition
        re-check) as the legacy all-jobs scan. A handler may arm a new
        same-tick deadline on another job (e.g. a preemption donor with a
        zero-length reschedule window): the legacy scan reaches that job in
        the same pass only if it sits later in index order, so newly due
        entries join the pass only when their index is still ahead; earlier
        ones are re-queued for the next tick."""
        h = self._until_heap
        due: List[int] = []             # min-heap of due job indices
        while h and h[0][0] <= t + _EPS:
            _until, i, g = heapq.heappop(h)
            if g == self._gen[i]:
                heapq.heappush(due, i)
        last = -1
        while due:
            i = heapq.heappop(due)
            if i <= last:               # re-armed duplicate: once per pass
                continue
            last = i
            job = self._by_idx[i]
            if job.until <= t + _EPS and job.state not in _UNTIMED:
                self._advance_phase(job, t)
            while h and h[0][0] <= t + _EPS:
                entry = heapq.heappop(h)
                _u2, i2, g2 = entry
                if g2 != self._gen[i2]:
                    continue
                if i2 > last:
                    heapq.heappush(due, i2)
                else:
                    heapq.heappush(h, entry)    # next tick, like legacy
                    break

    def _process(self, t: float) -> None:
        prof = self._prof
        if prof is not None:
            tp = time.perf_counter()
        self._nas_completions(t)
        if prof is not None:
            now = time.perf_counter()
            prof["nas"] += now - tp
            tp = now
        self.topo.repair_due(t)
        self._advance_due(t)
        if prof is not None:
            now = time.perf_counter()
            prof["phases"] += now - tp
            tp = now
        for i in sorted(self._waiting_set):
            job = self._by_idx[i]
            if job.state == WAITING:
                self._retry_waiting(job, t)
        # regrow runs after parked recoveries retried (a below-floor recovery
        # outranks a comfort regrow) and before new admissions (_try_admit)
        self._maybe_regrow(t, [self._by_idx[i]
                               for i in sorted(self._shrunk_set)])
        if prof is not None:
            now = time.perf_counter()
            prof["retry_regrow"] += now - tp
            tp = now
        # exact-condition vectorized prefilter over the running jobs, then
        # the per-job legacy re-check (an earlier marker can complete a job
        # and admit successors mid-pass)
        fired = np.flatnonzero(self._running_arr
                               & (self._done_arr >= self._marker_arr - _EPS))
        for i in fired:
            job = self._by_idx[int(i)]
            if job.state == RUNNING and job.done >= self._marker(job) - _EPS:
                self._at_marker(job, t)
        if prof is not None:
            now = time.perf_counter()
            prof["markers"] += now - tp
            tp = now
        self._dispatch_events(t)
        self._try_admit(t)
        if prof is not None:
            prof["events_admit"] += time.perf_counter() - tp

    def _run_legacy(self) -> None:
        """The poll-everything loop the indexed dispatcher replaced, kept
        verbatim for the same-machine A/B (``legacy_dispatch=True``): every
        wakeup rescans all jobs for candidate deadlines, termination rescans
        every state, and progress banks per job in Python."""
        guard = 0
        while any(j.state != DONE for j in self.jobs.values()):
            guard += 1
            if guard > 5_000_000:
                raise RuntimeError("fleet loop did not converge")
            self._ticks += 1
            t_now = self.clock.seconds
            cands: List[float] = []
            if self.events:
                cands.append(self.events.peek_time())
            nc = self.nas.next_completion()
            if nc is not None:
                cands.append(nc)
            waiting_or_pending = any(j.state in (PENDING, WAITING)
                                     for j in self.jobs.values())
            for job in self.jobs.values():
                if job.state == RUNNING:
                    view = self._view(job)
                    if len(view.assigned) < job.spec.n_nodes:
                        # shrunken job: wake at the next repair so the
                        # planner can take the regrow-on-repair rung
                        waiting_or_pending = True
                    r = job.rate(view)
                    if r > 0:
                        cands.append(
                            t_now + max(self._marker(job) - job.done, 0.0) / r)
                    else:
                        waiting_or_pending = True
                elif job.until < math.inf:
                    cands.append(job.until)
            if waiting_or_pending:
                nr = self._next_repair()
                if nr is not None:
                    cands.append(nr)
            if not cands:
                raise RuntimeError(
                    "fleet deadlock: no runnable job, no pending event "
                    f"(states: {[j.state for j in self.jobs.values()]})")
            t_next = max(min(cands), t_now)
            # bank productive progress for every running job
            dt = t_next - t_now
            for job in self.jobs.values():
                if job.state == RUNNING:
                    job.done += dt * job.rate(self._view(job))
            self.clock.advance_to(t_next)
            self._process_legacy(t_next)

    def _process_legacy(self, t: float) -> None:
        self._nas_completions_legacy(t)
        self.topo.repair_due(t)
        for job in self.jobs.values():
            if job.until <= t + _EPS and job.state not in (PENDING, RUNNING,
                                                           WAITING, DONE):
                self._advance_phase(job, t)
        for job in self.jobs.values():
            if job.state == WAITING:
                self._retry_waiting(job, t)
        # regrow runs after parked recoveries retried (a below-floor recovery
        # outranks a comfort regrow) and before new admissions (_try_admit)
        self._maybe_regrow(t, [
            j for j in self.jobs.values()
            if j.state == RUNNING and j.spec.name in self.sched.views
            and len(self._view(j).assigned) < j.spec.n_nodes])
        for job in self.jobs.values():
            if job.state == RUNNING and job.done >= self._marker(job) - _EPS:
                self._at_marker(job, t)
        self._dispatch_events(t)
        self._try_admit(t)

    def _dispatch_events(self, t: float) -> None:
        for group in group_domain_incidents(self.events.pop_due(t)):
            first = group[0][1]
            if isinstance(first, FaultEvent):
                self._handle_incident(t, [p for _t_ev, p in group])
            elif isinstance(first, tuple) and first[0] == "submit":
                if self.sched.submit(self.specs[first[1]]) is not None:
                    self._newly_admitted.append(first[1])
            elif isinstance(first, tuple) and first[0] == "tee_flush":
                self._handle_tee_flush(t, first[1])
            elif isinstance(first, tuple) and first[0] == "demote":
                # background TieredStore demotion: a flow on the shared NAS
                # no job owns — foreground saves/restores contend with it
                fid = self.nas.start(t, first[1], "tier:demote")
                self._demote_fids.add(fid)
                self.counts["demotions_started"] += 1

    # -- report ------------------------------------------------------------ #
    def _job_report(self, job: _Job) -> dict:
        spec = job.spec
        wall = max(job.finished_at - job.admitted_at, _EPS)
        return {
            "priority": spec.priority,
            "n_nodes": spec.n_nodes,
            "min_nodes": spec.min_nodes,
            "policy": job.pol.name,
            "submitted_at_s": round(spec.submit_at_s, 3),
            "admitted_at_s": round(job.admitted_at, 3),
            "finished_at_s": round(job.finished_at, 3),
            "queue_wait_s": round(job.admitted_at - spec.submit_at_s, 3),
            "end_to_end_days": round(wall / DAY_S, 6),
            "effective_time_ratio": round(job.need / wall, 4),
            "lost_steps": int(round(job.lost_s / spec.step_time_s)),
            "final_nodes": job.final_nodes,
            "recovery": {
                "restarts": len(job.restart_times),
                "mean_restart_s": round(float(np.mean(job.restart_times)), 1)
                if job.restart_times else 0.0,
                "total_downtime_s": round(job.downtime_s, 1),
                "waits_for_repair": job.counts["waits"],
                "repair_wait_s": round(job.wait_s, 1),
            },
            "restore_sources": dict(sorted(job.restore_sources.items())),
            **({"prefetch": {"started": job.counts["prefetch_started"],
                             "hits": job.counts["prefetch_hits"]}}
               if self.cfg.restore_prefetch else {}),
            "saves": {k.split("_", 1)[1]: v for k, v in job.counts.items()
                      if k.startswith("saves_")},
            "faults": {"hit": job.counts["faults_hit"],
                       "absorbed_in_recovery": job.counts["absorbed"],
                       "domain_hits": job.counts["domain_hits"]},
            "preemption": {"donations_given": job.counts["donations_given"],
                           "donations_taken": job.counts["donations_taken"]},
            "shrinks": job.counts["shrinks"],
            "regrows": job.counts["regrows"],
        }

    def _report(self) -> dict:
        cfg = self.cfg
        elapsed = max(self.clock.seconds, _EPS)
        goodput_node_s = sum(j.need * j.spec.n_nodes
                             for j in self.jobs.values())
        correlated = [
            {"t": round(t, 3), "domain": dom, "jobs": sorted(names)}
            for (t, dom), names in sorted(self.correlated.items())]
        report = {
            "engine": "fleet",
            "seed": self.seed,
            "config": {
                "n_nodes": cfg.n_nodes,
                "n_spares": cfg.n_spares,
                "nodes_per_rack": cfg.nodes_per_rack,
                "repair_hours": cfg.repair_hours,
                "nas_bw_total": cfg.nas_bw_total,
                "preemption": cfg.preemption,
                "mtbf_node_days": cfg.mtbf_node_days,
                "rack_mtbf_days": cfg.rack_mtbf_days,
                "n_jobs": len(cfg.jobs),
                **({"restore_prefetch": True} if cfg.restore_prefetch
                   else {}),
                **({"tier_correlated": True} if cfg.tier_correlated else {}),
                **({"demotion_flows": len(cfg.demotion_traffic)}
                   if cfg.demotion_traffic else {}),
            },
            "makespan_days": round(elapsed / DAY_S, 6),
            "fleet": {
                "utilization": round(goodput_node_s
                                     / (cfg.n_nodes * elapsed), 4),
                "goodput_node_days": round(goodput_node_s / DAY_S, 4),
                "preemptions": self.counts["preemptions"],
                "scheduler": dict(self.sched.stats),
                "nas": {"bw_total": cfg.nas_bw_total,
                        **dict(self.nas.stats),
                        **({"demotions": {
                            "started": self.counts["demotions_started"],
                            "drained": self.counts["demotions_drained"]}}
                           if cfg.demotion_traffic else {})},
            },
            "faults": {
                "injected": self.n_injected,
                "hit_jobs": self.counts["job_faults"],
                "idle": self.counts["idle_faults"],
                "unfired_at_completion": len(self.events),
            },
            "correlated_events": correlated,
            "jobs": {name: self._job_report(j)
                     for name, j in sorted(self.jobs.items())},
            # the shared RecoveryPlanner's structured decision log (every
            # job's recoveries interleaved on the one fleet timeline)
            "decisions": self.planner.log.to_report(cap=100),
            "one_clock": (self.topo.clock is self.clock
                          and self.events.clock is self.clock),
        }
        if self.tee is not None:
            report["tee"] = {
                "stats": dict(self.tee.stats),
                "correlation_window_s": cfg.tee_correlation_s,
                "n_domain_incidents": len(self.tee_incidents),
                "incidents": self.tee_incidents,
            }
        return report


def run_fleet(cfg: FleetConfig, seed: Optional[int] = None) -> dict:
    """Run one multi-job fleet simulation; returns its deterministic JSON
    report (shared schema, see :mod:`repro.report`). ``seed`` overrides
    ``cfg.seed``. Module-level overrides: :func:`set_force_legacy` flips
    every run onto the legacy dispatcher (the equivalence suite's hook);
    :func:`set_profile` attaches a volatile ``measured`` section (wall time,
    ticks, per-phase breakdown) without changing the report body."""
    from repro_torch.report import finalize

    use_seed = cfg.seed if seed is None else seed
    if _FORCE_LEGACY and not cfg.legacy_dispatch:
        cfg = replace(cfg, legacy_dispatch=True)
    run = _FleetRun(cfg, use_seed)
    if _PROFILE and not cfg.legacy_dispatch:
        run._prof = {k: 0.0 for k in ("deadline_bank", "nas", "phases",
                                      "retry_regrow", "markers",
                                      "events_admit")}
    report = finalize(run.run(), engine="fleet", seed=use_seed)
    if _PROFILE:
        wall = max(run._wall_s, 1e-9)
        measured = {
            "dispatch": "legacy" if cfg.legacy_dispatch else "indexed",
            "ticks": run._ticks,
            "wall_s": round(run._wall_s, 6),
            "ticks_per_s": round(run._ticks / wall, 1),
        }
        if run._prof is not None:
            measured["profile_s"] = {k: round(v, 6)
                                     for k, v in sorted(run._prof.items())}
        report["measured"] = measured
    return report


def no_preemption(cfg: FleetConfig) -> FleetConfig:
    """The identical fleet (same jobs, same fault timeline) with preemption
    disabled — the baseline the priority_preemption preset compares against."""
    return replace(cfg, preemption=False)
