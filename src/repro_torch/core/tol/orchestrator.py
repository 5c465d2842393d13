"""Transom Operator — the closed training loop (paper Fig. 1, right side).

Wires everything together around a *real* jax train step:

  launch -> warm-up -> run steps
     - every K steps: TCE async checkpoint (no stall)
     - every J steps: poll TEE on the live metric window
     - on anomaly/exception: FSM -> CHECKING, run error-check tasks
         bad node found  -> evict + anti-affinity reschedule + TCE ring-
                            backup restore on the fresh node  (steps 9-11)
         no bad node     -> in-place restart                   (step 8)
       -> WARMUP -> resume from the latest cached checkpoint

Each launcher holds a lease against the stateless TransomServer; the master
launcher distributes the task suites. Modeled wall-clock costs of each phase
are charged to a SimClock so benchmarks report cluster-scale times while the
training itself really runs.

Counterpart of ``repro.core.tol.orchestrator``: the reference's source with
the import prefix rewritten and three departures.

* An explicit device. The port's warm-up and error-check suites take the
  device their burn-in runs on; ``TransomOperator(device=None)`` resolves it
  (the card unless ``"cpu"`` is asked for) and hands it to both suites, so
  the burn-in runs on the card the job trains on.
* The initial state is snapshotted. The port's train step updates params
  and moments in place, so a fault before the first checkpoint must not
  fall back to ``init_state`` (by then the trained tensors): ``run_job``
  keeps a host copy (``flatten_pytree``) when it starts and falls back to
  ``unflatten_like(init_state, that copy)``.
* Imports: the engine ``_rebuild_engine`` builds is the port's.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.tce.engine import TCEngine, flatten_pytree, unflatten_like
from repro_torch.core.tee.service import TEEService
from repro_torch.core.tee.traces import TraceGenerator
from repro_torch.recovery import (REGROW, ClusterState, CostModel, Incident,
                            RecoveryExecutor, RecoveryPlanner, fill_slots)
from repro_torch.recovery.executor import GAVE_UP
from repro_torch.sim.clock import SimClock

from .cluster import ClusterSim, NodeState
from .fsm import JobState, LauncherFSM
from .server import TransomServer
from .tasks import error_check_tasks, warmup_tasks


class SimulatedFault(Exception):
    def __init__(self, category: str, node_rank: int, degrades_only: bool = False):
        super().__init__(f"{category} on rank {node_rank}")
        self.category = category
        self.node_rank = node_rank
        self.degrades_only = degrades_only


@dataclass(frozen=True)
class PhaseCosts:
    """Modeled seconds per recovery phase (calibrated to the paper's claims:
    average restart ~10-12 min with TRANSOM vs hours-to-days manual)."""
    tee_detect: float = 15.0
    error_check: float = 90.0
    evict_reschedule: float = 360.0
    inplace_restart: float = 120.0
    warmup: float = 60.0
    restore_from_cache: float = 10.0
    restore_from_backup: float = 16.0


@dataclass(frozen=True)
class JobConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    tee_every: int = 10
    n_sim_nodes: int = 4
    max_restarts: int = 20
    allow_shrink: bool = False     # elastic: continue on fewer nodes when the
    min_nodes: int = 2             # spare pool is exhausted (TCE reshards)
    costs: PhaseCosts = PhaseCosts()


@dataclass
class Launcher:
    rank: int
    node: str
    is_master: bool = False


@dataclass
class JobReport:
    completed: bool
    steps_done: int
    restarts_inplace: int = 0
    restarts_resched: int = 0
    shrinks: int = 0
    final_nodes: int = 0
    evicted_nodes: List[str] = field(default_factory=list)
    modeled_downtime_s: float = 0.0
    modeled_restart_times: List[float] = field(default_factory=list)
    state_history: List[Tuple[float, str, str]] = field(default_factory=list)
    lost_steps: int = 0
    tee_verdicts: int = 0
    # the RecoveryPlanner's structured decision log for this job
    decisions: List[dict] = field(default_factory=list)
    # accumulated across every recovery restore (survives elastic engine
    # rebuilds, which reset the engine's own stats)
    restore_sources: Dict[str, int] = field(default_factory=dict)

    @property
    def mean_restart_s(self) -> float:
        return float(np.mean(self.modeled_restart_times)) \
            if self.modeled_restart_times else 0.0


class TransomOperator:
    def __init__(self, server: TransomServer, cluster: ClusterSim,
                 tce: TCEngine, tee: Optional[TEEService] = None,
                 clock: Optional[SimClock] = None, verbose: bool = False,
                 job_id: Optional[str] = None,
                 planner: Optional[RecoveryPlanner] = None, device=None):
        self.device = resolve_device(device)
        self.server = server
        self.cluster = cluster
        self.tce = tce
        self.tee = tee
        # one clock across the whole substrate: by default adopt the engine's
        # (which in turn adopted the fabric's / topology's / store's)
        self.clock = clock or tce.clock
        # every recovery decision (replace vs shrink vs fail, regrow) routes
        # through the shared cost-aware planner; engines keep mechanism only
        self.planner = planner or RecoveryPlanner()
        self.verbose = verbose
        # claimant identity in the shared-topology lease ledger: per-job
        # operators on one fleet topology (repro.fleet.JobView) arbitrate
        # replacement claims under this name and can never be handed a node
        # already leased to a concurrent job
        self.job_id = (job_id or getattr(cluster, "job_id", None)
                       or getattr(cluster, "DEFAULT_CLAIMANT", "job0"))
        self._step = 0      # deterministic step index for decision logs
        self.launchers: List[Launcher] = []
        # FSM audit history is stamped in deterministic sim-time
        self.fsm = LauncherFSM(clock=self.clock)

    # ------------------------------------------------------------------ #
    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[TOL {self.fsm.state.value:>16s}] {msg}")

    def _spawn_launchers(self, n: int) -> None:
        self.launchers = [Launcher(r, self.cluster.assigned[r])
                          for r in range(n)]
        if hasattr(self.cluster, "rebind_ranks"):
            self.cluster.rebind_ranks([l.node for l in self.launchers])
        self._elect()

    def _elect(self) -> None:
        for l in self.launchers:
            lease = self.server.acquire("job-master", l.rank)
            l.is_master = lease is not None and lease.holder == l.rank
        master = [l for l in self.launchers if l.is_master]
        self._log(f"elected master: rank {master[0].rank if master else '?'}")

    def _rank_to_node(self) -> Dict[int, str]:
        return {l.rank: l.node for l in self.launchers}

    # ------------------------------------------------------------------ #
    def run_job(self, cfg: JobConfig, init_state,
                step_fn: Callable,
                fault_hook: Optional[Callable[[int], None]] = None,
                trace_gen: Optional[TraceGenerator] = None
                ) -> Tuple[JobReport, Any]:
        """Run `total_steps` of `step_fn(state, step) -> state` under full
        TOL+TEE+TCE protection. `fault_hook(step)` may raise SimulatedFault."""
        report = JobReport(False, 0)
        log_start = len(self.planner.log.entries)
        # remembered for grow(): scenario hooks regrow mid-run and their
        # decision-log entries must be priced with this job's costs
        costs_cm = self._costs_cm = CostModel.from_phase_costs(cfg.costs)
        self._spawn_launchers(cfg.n_sim_nodes)
        state = init_state
        init_flat = flatten_pytree(init_state)
        step = 0
        trace_gen = trace_gen or TraceGenerator(n_ranks=cfg.n_sim_nodes)

        self.fsm.to(JobState.WARMUP, "initial launch")
        self._warmup(cfg, report)
        self.fsm.to(JobState.RUNNING, "warmup passed")

        pending_fault: Optional[SimulatedFault] = None
        while step < cfg.total_steps and not self.fsm.terminal:
            try:
                if fault_hook is not None:
                    fault_hook(step)
                state = step_fn(state, step)
                step += 1
                self._step = step
                report.steps_done = step
                if step % cfg.ckpt_every == 0:
                    self.tce.save(step, state)   # async: no training stall
                # TEE periodic poll: in real deployments this reads live
                # metrics; here a verdict only fires when a fault is pending
                if self.tee is not None and step % cfg.tee_every == 0:
                    report.tee_verdicts += 1
                continue
            except SimulatedFault as f:
                pending_fault = f

            # ---------------- recovery path ---------------- #
            if report.restarts_inplace + report.restarts_resched \
                    >= cfg.max_restarts:
                self.fsm.to(JobState.FAILED, "restart budget exhausted")
                break
            t_down = cfg.costs.tee_detect
            self.fsm.to(JobState.CHECKING, str(pending_fault))
            self._log(f"anomaly at step {step}: {pending_fault}")

            # TEE window scoring for node attribution: the trace is generated
            # from the *injected* fault (same category, same rank), so the
            # detector is exercised on exactly what the cluster experienced
            bad_ranks: List[int] = []
            if self.tee is not None and pending_fault is not None:
                gen = trace_gen
                if pending_fault.node_rank >= gen.n_ranks:
                    # fleet grew past the generator's rank count: size a
                    # fresh one to the current launchers
                    gen = TraceGenerator(n_ranks=len(self.launchers))
                tr = gen.for_fault(
                    pending_fault.category, pending_fault.node_rank,
                    T=240, onset=120,
                    degrades_only=pending_fault.degrades_only)
                v = self.tee.detect_task(tr)
                report.tee_verdicts += 1
                if v.anomalous:
                    bad_ranks = [pending_fault.node_rank]
            checks = error_check_tasks(self.cluster, bad_ranks,
                                       self._rank_to_node(), device=self.device)
            t_down += cfg.costs.error_check
            # TEE attribution is advisory (paper §IV-B: "confirmation of error
            # nodes relies on the TOL system"); only hardware/infra checks
            # justify eviction. TEE narrows which flagged node to evict first.
            hw_bad = {n for c in checks if c.name != "tee_attribution"
                      for n in c.bad_nodes}
            tee_bad = {n for c in checks if c.name == "tee_attribution"
                       for n in c.bad_nodes}
            bad_nodes = sorted(hw_bad, key=lambda n: (n not in tee_bad, n))

            if bad_nodes:
                self.fsm.to(JobState.RESCHEDULING, f"evict {bad_nodes}")
                for n in bad_nodes:
                    self.server.report_bad_node(n)
                    self.cluster.evict(n, self.clock.seconds)
                    for l in self.launchers:
                        if l.node == n:
                            self.tce.node_failed(l.rank)
                            report.evicted_nodes.append(n)
                # a rack with 2+ bad nodes points at a correlated root cause
                # (switch/PDU): keep replacements out of that failure domain
                rack_hits: Dict[str, int] = {}
                for n in bad_nodes:
                    if n in self.cluster.nodes:
                        r = self.cluster.domain_of(n)
                        rack_hits[r] = rack_hits.get(r, 0) + 1
                avoid_domains = {r for r, c in rack_hits.items() if c >= 2}
                # replace-vs-shrink-vs-fail is the planner's call; this loop
                # only executes the plan through the claim ledger
                pending = [l for l in self.launchers if l.node in bad_nodes]
                n_target = len(self.launchers)

                def _cstate() -> ClusterState:
                    return ClusterState(
                        n_assigned=n_target - len(pending),
                        n_target=n_target,
                        min_nodes=cfg.min_nodes if cfg.allow_shrink
                        else n_target,
                        free_supply=self.cluster.claimable_supply(
                            self.server.bad_nodes()))

                def _claim() -> bool:
                    new = self.cluster.schedule_replacement(
                        self.server.bad_nodes(),
                        avoid_domains=avoid_domains,
                        claimant=self.job_id)
                    if new is None:
                        return False
                    l = pending.pop(0)
                    l.node = new
                    self.cluster.bind_rank(l.rank, new)
                    self.tce.node_recovered(l.rank)   # ring-backup pull
                    return True

                def _do_shrink() -> None:
                    # elastic shrink: drop the dead ranks, reshard the
                    # checkpoint engine onto the surviving nodes
                    self._shrink(bad_nodes)
                    report.shrinks += 1
                    self._log(f"elastic shrink -> {len(self.launchers)} nodes")

                outcome = fill_slots(
                    self.planner,
                    # closed-loop decision logs are step-indexed: the shared
                    # clock is also advanced by the async reconciler thread,
                    # so its mid-run reads are not deterministic — the step
                    # counter is this engine's deterministic timeline
                    Incident("fault", float(step),
                             victims=tuple(sorted(bad_nodes)),
                             categories=(pending_fault.category,)),
                    _cstate,
                    RecoveryExecutor(missing=lambda: len(pending),
                                     try_claim=_claim,
                                     do_shrink=_do_shrink),
                    costs=costs_cm, job=self.job_id)
                if outcome == GAVE_UP:
                    self.fsm.to(JobState.FAILED, "no replacement nodes")
                    break
                self._elect()
                t_down += cfg.costs.evict_reschedule + cfg.costs.restore_from_backup
                report.restarts_resched += 1
            else:
                self.fsm.to(JobState.RECOVER_INPLACE, "no bad node found")
                self.planner.plan(
                    Incident("fault", float(step),
                             categories=(pending_fault.category,)),
                    ClusterState(n_assigned=len(self.launchers),
                                 n_target=len(self.launchers),
                                 min_nodes=cfg.min_nodes),
                    costs=costs_cm, job=self.job_id)
                t_down += cfg.costs.inplace_restart + cfg.costs.restore_from_cache
                report.restarts_inplace += 1

            # restore from the freshest checkpoint (memory-first waterfall).
            # All nodes are healthy again here: give the reconciler a bounded
            # window to finish in-flight persists/backups so the newest step
            # is recoverable when possible (a fault racing a save still falls
            # back one interval — the paper's "near-simultaneous" caveat).
            self.tce.reconciler.quiesce(10)
            try:
                ck_step, flat = self.tce.restore()
                for k, v in self.tce.stats["restore_sources"].items():
                    report.restore_sources[k] = \
                        report.restore_sources.get(k, 0) + v
            except FileNotFoundError:
                ck_step, flat = 0, None
            if flat is not None:
                state = unflatten_like(init_state, flat)
            else:
                state = unflatten_like(init_state, init_flat)
            report.lost_steps += step - ck_step
            step = ck_step
            report.steps_done = step

            self.fsm.to(JobState.WARMUP, "recovered")
            self._warmup(cfg, report)
            t_down += cfg.costs.warmup
            self.fsm.to(JobState.RUNNING, f"resumed from step {ck_step}")
            self.clock.advance(t_down)
            report.modeled_downtime_s += t_down
            report.modeled_restart_times.append(t_down)
            pending_fault = None

        if step >= cfg.total_steps and not self.fsm.terminal:
            self.fsm.to(JobState.DONE, "target steps reached")
            report.completed = True
        report.final_nodes = len(self.launchers)
        report.state_history = [(t, s.value, r) for t, s, r in self.fsm.history]
        report.decisions = self.planner.log.entries[log_start:]
        return report, state

    def _rebuild_engine(self, launchers: List[Launcher]) -> None:
        """Re-rank `launchers` 0..k-1 and rebuild TCE on that ring. The last
        durable checkpoint reshards across the new node count on the next
        restore (store_full path)."""
        from repro_torch.core.tce.engine import TCEngine, TCEConfig

        self.tce.reconciler.quiesce(30)
        old = self.tce
        cfg = old.cfg
        old.close()
        for new_rank, l in enumerate(launchers):
            l.rank = new_rank
        self.launchers = launchers
        if hasattr(self.cluster, "rebind_ranks"):
            self.cluster.rebind_ranks([l.node for l in launchers])
        # the fabric is node-count-independent: reuse it so its clock/topology
        # binding and transfer counters survive the rebuild. Ranks were just
        # renumbered and every launcher in the new ring is a live node, so
        # stale rank-down markers from the old numbering must not carry over.
        for l in launchers:
            old.fabric.restore_node(l.rank)
        import dataclasses
        self.tce = TCEngine(
            dataclasses.replace(cfg, n_nodes=len(launchers)),
            old.store, fabric=old.fabric, clock=self.clock)
        # counters are cumulative job-level stats; restore_sources stays
        # per-restore (JobReport accumulates it across rebuilds)
        for k in ("saves", "restores", "fetch_requests", "fetch_transfers"):
            self.tce.stats[k] += old.stats[k]

    def _shrink(self, bad_nodes) -> None:
        """Elastic shrink: continue on the surviving nodes."""
        survivors = [l for l in self.launchers if l.node not in bad_nodes]
        self._rebuild_engine(survivors)

    def grow(self, n_new: int = 1) -> int:
        """Elastic grow: pull healthy nodes (spares or repaired machines) back
        into the job and reshard the checkpoint ring onto the larger fleet.

        Safe to call between steps (e.g. from a scenario hook once repairs
        complete). The regrow-vs-stay decision (pay a reshard now vs keep
        running small) is the planner's; this method only executes the
        claims. Returns how many nodes were actually added."""
        plan = self.planner.plan_regrow(
            ClusterState(
                n_assigned=len(self.launchers),
                n_target=len(self.launchers) + n_new,
                min_nodes=len(self.launchers),
                free_supply=self.cluster.claimable_supply(
                    self.server.bad_nodes())),
            t=float(self._step), job=self.job_id,
            costs=getattr(self, "_costs_cm", None))
        if plan.decision != REGROW:
            return 0
        added: List[Launcher] = []
        for _ in range(n_new):
            new = self.cluster.schedule_replacement(self.server.bad_nodes(),
                                                    claimant=self.job_id)
            if new is None:
                break
            added.append(Launcher(len(self.launchers) + len(added), new))
        if not added:
            return 0
        self._rebuild_engine(self.launchers + added)
        self._elect()
        self._log(f"elastic grow -> {len(self.launchers)} nodes")
        return len(added)

    # ------------------------------------------------------------------ #
    def _warmup(self, cfg: JobConfig, report: JobReport) -> None:
        results = warmup_tasks(self.cluster, device=self.device)
        failed = [r for r in results if not r.ok]
        if failed:
            bad = sorted({n for r in failed for n in r.bad_nodes})
            self._log(f"warmup found bad nodes: {bad}")
            for n in bad:
                self.server.report_bad_node(n)
                self.cluster.evict(n, self.clock.seconds)
                self.cluster.schedule_replacement(self.server.bad_nodes(),
                                                  claimant=self.job_id)
