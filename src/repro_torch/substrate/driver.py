"""The shared recovery driver: TOL/TEE/planner against the Substrate protocol.

:func:`run_protected` is the one training-keeper loop for both substrates.
It speaks only the :class:`repro.substrate.base.Substrate` surface —
``start_ranks / kill / step_metrics / save_via_tce / restore_via_tce`` plus
the shared control-plane handles (``clock``, ``topology``, ``server``,
``tee``) — and by design contains **no** ``isinstance`` dispatch: anything
this loop proves on the modelled cluster (:class:`SimSubstrate`) holds
verbatim when the ranks are real SIGKILL-able processes
(:class:`ProcessSubstrate`).

The recovery flow mirrors the closed-loop orchestrator
(:class:`repro.core.tol.TransomOperator`), phase by phase:

1. a fault surfaces as a failed ``step_metrics`` slice (synchronous
   data-parallel: a dead rank is a failed step, not an async event);
2. FSM -> CHECKING; TEE scores a fault-window trace per dead rank
   (advisory attribution), then the error-check task suite runs — only
   hardware/infra checks justify eviction;
3. bad nodes are reported to the TransomServer, evicted from the Topology,
   and replacement slots are resolved by the shared
   :class:`~repro.recovery.RecoveryPlanner` through
   :func:`~repro.recovery.fill_slots` (claim ladder, anti-affinity against
   known-bad nodes, rack avoidance on correlated hits);
4. ranks restart (``start_ranks``), state rewinds through the TCE restore
   path, and the loss curve re-grows from the checkpoint — deterministic
   replay makes the merged curve identical to an uninterrupted run.

Phase costs charge to the substrate's SimClock exactly as in the
orchestrator, so modelled downtime is comparable across engines.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.tol import JobState, LauncherFSM, error_check_tasks
from repro_torch.core.tol.orchestrator import PhaseCosts
from repro_torch.recovery import (ClusterState, CostModel, Incident,
                            RecoveryExecutor, RecoveryPlanner, fill_slots)
from repro_torch.recovery.executor import GAVE_UP
from repro_torch.report import finalize

from .base import FaultNotice, Substrate


@dataclass(frozen=True)
class KillSpec:
    """One scripted fault injection: SIGKILL/fail ``rank`` when training
    first reaches ``step`` (fires once, even across rewind-and-replay)."""
    step: int
    rank: int
    category: str = "node_hw"

    @classmethod
    def parse(cls, text: str) -> "KillSpec":
        """Parse ``"STEP:RANK"`` or ``"STEP:RANK:CATEGORY"``."""
        parts = text.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad kill spec {text!r} "
                             f"(want STEP:RANK[:CATEGORY])")
        step, rank = int(parts[0]), int(parts[1])
        return cls(step, rank, parts[2] if len(parts) == 3 else "node_hw")

    @classmethod
    def parse_list(cls, text: str) -> Tuple["KillSpec", ...]:
        """Parse a comma-separated kill schedule (empty -> no kills)."""
        items = [p for p in text.split(",") if p.strip()]
        return tuple(cls.parse(p.strip()) for p in items)


@dataclass(frozen=True)
class StallSpec:
    """One scripted straggler injection: freeze ``rank`` for ``seconds``
    (SIGSTOP/SIGCONT on real processes) when training first reaches
    ``step``. The slice still completes; the slowdown surfaces in the
    per-rank wall times the streaming TEE attributes."""
    step: int
    rank: int
    seconds: float = 1.5

    @classmethod
    def parse(cls, text: str) -> "StallSpec":
        """Parse ``"STEP:RANK"`` or ``"STEP:RANK:SECONDS"``."""
        parts = text.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad stall spec {text!r} "
                             f"(want STEP:RANK[:SECONDS])")
        step, rank = int(parts[0]), int(parts[1])
        return cls(step, rank, float(parts[2]) if len(parts) == 3 else 1.5)

    @classmethod
    def parse_list(cls, text: str) -> Tuple["StallSpec", ...]:
        """Parse a comma-separated stall schedule (empty -> no stalls)."""
        items = [p for p in text.split(",") if p.strip()]
        return tuple(cls.parse(p.strip()) for p in items)


@dataclass(frozen=True)
class DriveConfig:
    """One protected run's knobs (mirrors the orchestrator's JobConfig)."""
    total_steps: int = 40
    ckpt_every: int = 10
    seed: int = 0
    max_restarts: int = 8
    costs: PhaseCosts = field(default_factory=PhaseCosts)
    # speculative restore prefetch: stage the checkpoint the moment a fault
    # is detected, so the restore leg overlaps the check/reschedule window
    prefetch: bool = True
    scenario: str = "substrate_run"


def run_protected(sub: Substrate, cfg: DriveConfig,
                  kills: Sequence[KillSpec] = (),
                  stalls: Sequence[StallSpec] = (),
                  planner: Optional[RecoveryPlanner] = None) -> dict:
    """Train ``sub`` to ``cfg.total_steps`` under TOL/TEE/planner recovery.

    Returns a finalized report (shared schema: ``engine="substrate"``) with
    the merged ``losses`` curve — faults rewind it to the checkpoint and
    deterministic replay re-grows it, so the final curve matches an
    uninterrupted run's.
    """
    wall_t0 = time.time()
    planner = planner or RecoveryPlanner()
    costs, costs_cm = cfg.costs, CostModel.from_phase_costs(cfg.costs)
    log_start = len(planner.log.entries)
    fsm = LauncherFSM(clock=sub.clock)

    sub.server.acquire("job-master", 0)
    sub.start_ranks()
    fsm.to(JobState.WARMUP, "initial launch")
    sub.clock.advance(costs.warmup)
    fsm.to(JobState.RUNNING, "warmup passed")

    kill_q: List[KillSpec] = sorted(kills, key=lambda k: (k.step, k.rank))
    fired = [False] * len(kill_q)
    stall_q: List[StallSpec] = sorted(stalls, key=lambda s: (s.step, s.rank))
    sfired = [False] * len(stall_q)
    stalled_pending: set = set()
    stall_attributions: List[dict] = []
    losses: List[List[float]] = []
    saves: List[dict] = []
    evicted: List[str] = []
    restarts_inplace = restarts_resched = 0
    lost_steps = tee_verdicts = 0
    downtime = 0.0
    prefetch_restores = 0
    prefetch_overlap_s = 0.0
    restart_times: List[float] = []
    trace_gen = scorer = None
    if sub.tee is not None:
        from repro_torch.core.tee import TraceGenerator
        from repro_torch.tee_stream import StreamScorer
        trace_gen = TraceGenerator(n_ranks=sub.n_ranks)
        # online scoring path: the same ensemble the batch TEE holds, fed
        # incrementally through ring-buffered windows (repro.tee_stream)
        scorer = StreamScorer(sub.tee.m)

    step = 0
    while step < cfg.total_steps and not fsm.terminal:
        # fire every kill that is due at this step; each fires exactly once,
        # so rewind-and-replay does not re-kill on the second pass
        for i, k in enumerate(kill_q):
            if not fired[i] and k.step <= step:
                sub.kill(k.rank, k.category)
                fired[i] = True
        for i, s in enumerate(stall_q):
            if not sfired[i] and s.step <= step:
                sub.stall(s.rank, s.seconds)
                stalled_pending.add(s.rank)
                sfired[i] = True
        # run to the nearest boundary: next checkpoint, next scripted kill
        # or stall, or the finish line
        upto = min((step // cfg.ckpt_every + 1) * cfg.ckpt_every,
                   cfg.total_steps,
                   *(k.step for i, k in enumerate(kill_q)
                     if not fired[i] and k.step > step),
                   *(s.step for i, s in enumerate(stall_q)
                     if not sfired[i] and s.step > step))
        sl = sub.step_metrics(upto)
        losses.extend(sl.losses)
        step = sl.step
        if sl.ok:
            if stalled_pending and scorer is not None:
                # the slice survived but some rank was frozen mid-flight:
                # read the real per-rank wall times, pick the measured
                # slowest rank, and let the streaming TEE attribute it
                walls = dict(getattr(sub, "last_rank_walls", {}) or {})
                if walls:
                    slow = max(sorted(walls), key=lambda r: walls[r])
                    slowdown = walls[slow] / max(min(walls.values()), 1e-9)
                    # the stall was already in flight when this slice's
                    # window is examined, so the straggler signature spans
                    # the scored window from its first post-init sample
                    sv = scorer.score_trace(trace_gen.for_fault(
                        "straggler", slow, T=240, onset=40))
                    tee_verdicts += 1
                    stall_attributions.append({
                        "step": step,
                        "stalled_ranks": sorted(stalled_pending),
                        "slowest_rank": slow,
                        "slowdown": round(slowdown, 3),
                        "anomalous": bool(sv.verdict.anomalous),
                        "attributed_ranks": list(sv.verdict.bad_ranks),
                        "confidence": sv.confidence,
                        "detect_latency_samples": sv.latency,
                    })
                stalled_pending.clear()
            if step % cfg.ckpt_every == 0 and step < cfg.total_steps:
                committed = sub.save_via_tce(step)
                saves.append({"step": step, "committed": bool(committed)})
            continue

        # ---------------- recovery path ---------------- #
        fault: FaultNotice = sl.fault
        if restarts_inplace + restarts_resched >= cfg.max_restarts:
            fsm.to(JobState.FAILED, "restart budget exhausted")
            break
        t_down = costs.tee_detect
        fsm.to(JobState.CHECKING,
               f"ranks {list(fault.dead_ranks)} dead at step {step}")
        # speculative restore prefetch: stage the freshest checkpoint NOW,
        # so its bytes stream while the checks / reschedule / process
        # restarts below run — the restore leg then pays only the residual
        pf_step = sub.prefetch_restore() if cfg.prefetch else None

        # streaming TEE scoring per dead rank (advisory attribution: only
        # hardware/infra checks below justify eviction) — the fault window
        # flows through the online scorer, same verdicts as the old batch
        # detect_task rescan on the same trace
        bad_ranks: List[int] = []
        if scorer is not None:
            for r in fault.dead_ranks:
                tr = trace_gen.for_fault(
                    fault.categories.get(r, "node_hw"), r, T=240, onset=120)
                sv = scorer.score_trace(tr)
                tee_verdicts += 1
                if sv.verdict.anomalous:
                    bad_ranks.append(r)
        rank_to_node = {r: sub.topology.node_of_rank(r)
                        for r in range(sub.n_ranks)}
        checks = error_check_tasks(sub.topology, bad_ranks, rank_to_node, device=sub.device)
        t_down += costs.error_check
        hw_bad = {n for c in checks if c.name != "tee_attribution"
                  for n in c.bad_nodes}
        tee_bad = {n for c in checks if c.name == "tee_attribution"
                   for n in c.bad_nodes}
        bad_nodes = sorted(hw_bad, key=lambda n: (n not in tee_bad, n))

        if bad_nodes:
            fsm.to(JobState.RESCHEDULING, f"evict {bad_nodes}")
            for n in bad_nodes:
                sub.server.report_bad_node(n)
                sub.topology.evict(n, sub.clock.seconds)
                evicted.append(n)
            # 2+ bad nodes in one rack point at a correlated root cause:
            # keep replacements out of that failure domain
            rack_hits: Dict[str, int] = {}
            for n in bad_nodes:
                if n in sub.topology.nodes:
                    r = sub.topology.domain_of(n)
                    rack_hits[r] = rack_hits.get(r, 0) + 1
            avoid_domains = {r for r, c in rack_hits.items() if c >= 2}

            n_target = sub.n_ranks
            pending = sorted(r for r, n in rank_to_node.items()
                             if n in bad_nodes)
            assignments: Dict[int, str] = {}

            def _cstate() -> ClusterState:
                # the rank count is the gang size: the shard layout is
                # fixed, so there is no elastic shrink on this path
                return ClusterState(
                    n_assigned=n_target - len(pending),
                    n_target=n_target, min_nodes=n_target,
                    free_supply=sub.topology.claimable_supply(
                        sub.server.bad_nodes()))

            def _claim() -> bool:
                new = sub.topology.schedule_replacement(
                    sub.server.bad_nodes(), avoid_domains=avoid_domains,
                    claimant=sub.job_id)
                if new is None:
                    return False
                assignments[pending.pop(0)] = new
                return True

            outcome = fill_slots(
                planner,
                # step-indexed incident time: the deterministic timeline
                # shared with the closed-loop engines' decision logs
                Incident("fault", float(step),
                         victims=tuple(sorted(bad_nodes)),
                         categories=tuple(sorted(
                             set(fault.categories.values())) or ["node_hw"])),
                _cstate,
                RecoveryExecutor(missing=lambda: len(pending),
                                 try_claim=_claim),
                costs=costs_cm, job=sub.job_id)
            if outcome == GAVE_UP:
                fsm.to(JobState.FAILED, "no replacement nodes")
                break
            leg = costs.restore_from_backup
            if pf_step is not None:
                # the staged stream overlapped the check+reschedule window
                overlap = min(leg, costs.error_check + costs.evict_reschedule)
                prefetch_overlap_s += overlap
                prefetch_restores += 1
                leg -= overlap
            t_down += costs.evict_reschedule + leg
            restarts_resched += 1
            sub.start_ranks(assignments)
        else:
            # process died but no node attributable: restart in place
            fsm.to(JobState.RECOVER_INPLACE, "no bad node found")
            planner.plan(
                Incident("fault", float(step),
                         categories=tuple(sorted(
                             set(fault.categories.values())) or ["node_hw"])),
                ClusterState(n_assigned=sub.n_ranks, n_target=sub.n_ranks,
                             min_nodes=sub.n_ranks),
                costs=costs_cm, job=sub.job_id)
            leg = costs.restore_from_cache
            if pf_step is not None:
                overlap = min(leg, costs.error_check + costs.inplace_restart)
                prefetch_overlap_s += overlap
                prefetch_restores += 1
                leg -= overlap
            t_down += costs.inplace_restart + leg
            restarts_inplace += 1
            sub.start_ranks()

        ck = sub.restore_via_tce()
        lost_steps += step - ck
        step = ck
        # rewind the curve to the checkpoint: deterministic replay re-grows
        # the dropped tail bit-for-bit, keeping the merged curve continuous
        losses = [e for e in losses if e[0] <= ck]
        fsm.to(JobState.WARMUP, "recovered")
        t_down += costs.warmup
        fsm.to(JobState.RUNNING, f"resumed from step {ck}")
        sub.clock.advance(t_down)
        downtime += t_down
        restart_times.append(round(t_down, 3))

    if step >= cfg.total_steps and not fsm.terminal:
        fsm.to(JobState.DONE, "target steps reached")

    entries = planner.log.entries[log_start:]
    by_decision: Dict[str, int] = {}
    for e in entries:
        by_decision[e["decision"]] = by_decision.get(e["decision"], 0) + 1
    report = {
        "completed": fsm.state is JobState.DONE,
        "n_ranks": sub.n_ranks,
        "total_steps": cfg.total_steps,
        "ckpt_every": cfg.ckpt_every,
        "steps_done": step,
        "lost_steps": lost_steps,
        "restarts": {"inplace": restarts_inplace,
                     "resched": restarts_resched},
        "kills": [{"step": k.step, "rank": k.rank, "category": k.category}
                  for k in kill_q],
        "stalls": [{"step": s.step, "rank": s.rank, "seconds": s.seconds}
                   for s in stall_q],
        "evicted_nodes": evicted,
        "saves": saves,
        "tee_verdicts": tee_verdicts,
        "losses": losses,
        "final_loss": losses[-1][1] if losses else None,
        "modeled": {"downtime_s": round(downtime, 3),
                    "restart_times_s": restart_times,
                    "prefetch": {"restores": prefetch_restores,
                                 "overlap_s": round(prefetch_overlap_s, 3)},
                    "clock_s": round(sub.clock.seconds, 3)},
        "state_history": [(round(t, 3), s.value, r)
                          for t, s, r in fsm.history],
        "decisions": {"n": len(entries), "by_decision": by_decision,
                      "log": entries[:50]},
        # measured = volatile (stripped from CI determinism diffs): real
        # wall clocks, incl. stall attributions whose slowdowns come from
        # actually-SIGSTOPped worker processes
        "measured": {"wall_s": round(time.time() - wall_t0, 3),
                     "stall_attribution": stall_attributions},
    }
    return finalize(report, engine="substrate", scenario=cfg.scenario,
                    seed=cfg.seed)
