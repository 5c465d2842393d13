"""Time-triggered soak engine: long-horizon TRANSOM runs on the event queue.

The named scenarios in ``repro.sim.scenarios`` fire faults on scripted *step
indices* and finish in seconds of simulated time. The soak engine instead
models days-to-weeks of training driven entirely from timestamps on the one
shared :class:`EventQueue`: per-node Table-I faults from
``FaultInjector.schedule()``, follow-on failures from ``cascade_events`` and
whole-rack outages from ``domain_outage_schedule`` are merged onto a single
timeline, and checkpoint saves, TEE detection latency, TOL
eviction/reschedule/shrink and the TCE restore waterfall (local cache ->
ring backup -> persistent store) all interleave as charges against the same
:class:`SimClock`.

Recovery is transactional: any attributable fault that lands *inside* a
recovery window (detection, repair waits, reschedule) joins the open
transaction — the cascading-double-fault case — and forces the restore down
the waterfall to the persistent store, exactly the behaviour the scripted
``cascading_double_fault`` scenario demonstrates at step scale.

Fleet slots: the injector's schedule names fleet *slots* (``node0013`` =
slot 13); whatever machine currently occupies a slot absorbs its faults, so
replacements inherit fault exposure and a shrunken fleet sees
proportionally fewer faults.

The run is fully seeded and emits a JSON-able report; the policy sweep
(``repro.sim.sweep``) uses ``effective_time_ratio`` as its objective.
"""
from __future__ import annotations

import math
import zlib
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.recovery import (TIER_NAS, CadenceController, ClusterState,
                            CostModel, Incident, RecoveryExecutor,
                            RecoveryPlanner, default_tiers, fill_slots)

from .clock import EventQueue, SimClock
from .faults import (FaultEvent, FaultInjector, cascade_events,
                     domain_outage_schedule, get_mix, merge_schedules,
                     push_schedule)
from .topology import NodeState, Topology

DAY_S = 86400.0

# coalesce same-(t, domain) member events of one correlated outage into a
# single incident before recovery opens (module flag so the equivalence test
# can pin coalesced == one-at-a-time)
COALESCE_INCIDENTS = True

# categories whose error checks surface a concrete bad node (hardware / NIC);
# the rest (storage, user_code, other) restart in place with no eviction
NODE_ATTRIBUTABLE = frozenset({"node_hw", "network"})


@dataclass(frozen=True)
class SoakPolicy:
    """Modelled costs of one fault-tolerance policy (the knobs Fig. 6
    compares): detection latency, recovery phases, checkpoint cadence and
    the per-source restore costs of the TCE waterfall."""
    name: str
    detect_mean_s: float          # anomaly -> noticed (exponential mean)
    weekend_frac: float           # fraction of faults hitting the long tail
    weekend_detect_s: float
    error_check_s: float
    evict_reschedule_s: float
    inplace_restart_s: float
    warmup_s: float
    ckpt_interval_s: float        # cadence, in productive training seconds
    ckpt_save_stall_s: float      # training stall per save
    restore_cache_s: float
    restore_backup_s: float
    restore_store_s: float
    has_ring_backup: bool = True  # False -> every restore hits the store


def transom_policy(ckpt_interval_s: float = 1800.0) -> SoakPolicy:
    """TEE detects in ~seconds, TCE saves asynchronously (~2 s stall) and
    restores from memory/ring backup; cadence is cheap to raise."""
    return SoakPolicy("transom", detect_mean_s=105.0, weekend_frac=0.0,
                      weekend_detect_s=0.0, error_check_s=90.0,
                      evict_reschedule_s=360.0, inplace_restart_s=120.0,
                      warmup_s=60.0, ckpt_interval_s=ckpt_interval_s,
                      ckpt_save_stall_s=2.0, restore_cache_s=10.0,
                      restore_backup_s=16.0, restore_store_s=255.0)


def manual_policy(ckpt_interval_s: float = 3 * 3600.0) -> SoakPolicy:
    """Kubeflow-style baseline: manual detection (hours; 60 h weekend tail),
    synchronous NAS saves that stall training, store-only restores."""
    return SoakPolicy("manual", detect_mean_s=3 * 3600.0, weekend_frac=0.2,
                      weekend_detect_s=60 * 3600.0, error_check_s=1800.0,
                      evict_reschedule_s=1800.0, inplace_restart_s=1800.0,
                      warmup_s=600.0, ckpt_interval_s=ckpt_interval_s,
                      ckpt_save_stall_s=255.0, restore_cache_s=255.0,
                      restore_backup_s=255.0, restore_store_s=255.0,
                      has_ring_backup=False)


@dataclass(frozen=True)
class SoakConfig:
    """One soak run: a cluster, a stochastic fault environment, a policy."""
    ideal_days: float = 7.0           # pure-compute time on the full fleet
    n_nodes: int = 16
    n_spares: int = 4
    nodes_per_rack: int = 8
    mtbf_node_days: float = 110.0
    straggler_frac: float = 0.15
    p_cascade: float = 0.1
    cascade_window_s: float = 600.0
    rack_mtbf_days: float = 0.0       # 0 disables whole-rack outages
    # min surviving fraction to keep running shrunk when the spare pool is
    # dry; 0 -> never shrink, stall the recovery until repairs land
    shrink_threshold: float = 0.5
    repair_hours: float = 24.0
    step_time_s: float = 30.0         # one training step, for lost_steps
    horizon_factor: float = 8.0       # fault schedule length vs ideal_days
    policy: SoakPolicy = transom_policy()
    planner_policy: str = "transom"   # RecoveryPlanner decision policy
    fault_mix: str = "table1"         # category mix (see faults.MIXES)
    # streaming TEE: detection latency per event comes from actually
    # streaming that category's signature trace through the Eagle Eye
    # scorer (deterministic, per-category) instead of an exponential draw
    tee_stream: bool = False
    # ---- N-tier checkpoint hierarchy ---------------------------------- #
    # tiers=True plans every restore over the full default_tiers()
    # hierarchy (device/dram/peer/ssd/nas/cold) via choose_restore_plan —
    # a correlated rack loss takes out the peer AND ssd tiers together;
    # nas_outages=((start_s, duration_s), ...) browns out the NAS tier so
    # restores in the window fall to the surviving tiers;
    # adaptive_cadence lets a CadenceController tighten/relax the save
    # interval as the decision log shows rollback costs rising/cooling
    tiers: bool = False
    nas_outages: Tuple[Tuple[float, float], ...] = ()
    adaptive_cadence: bool = False
    seed: int = 0


class _SoakRun:
    def __init__(self, cfg: SoakConfig, seed: int):
        self.cfg = cfg
        self.pol = cfg.policy
        self.seed = seed
        # policy-salted detection RNG (stable across processes); the fault
        # environment below is policy-independent so transom/manual compare
        # against the *same* schedule
        self.rng = np.random.default_rng(
            seed + zlib.crc32(self.pol.name.encode()) % 1000)
        self.clock = SimClock()
        self.topo = Topology(cfg.n_nodes, n_spares=cfg.n_spares,
                             repair_hours=cfg.repair_hours,
                             nodes_per_rack=cfg.nodes_per_rack,
                             clock=self.clock)
        horizon = cfg.ideal_days * cfg.horizon_factor
        weights = (None if cfg.fault_mix == "table1"
                   else dict(get_mix(cfg.fault_mix).weights))
        primary = FaultInjector(
            cfg.n_nodes, cfg.mtbf_node_days, horizon_days=horizon,
            straggler_frac=cfg.straggler_frac, seed=seed,
            weights=weights).schedule()
        schedule = cascade_events(primary, list(self.topo.nodes),
                                  p_cascade=cfg.p_cascade,
                                  recovery_window_s=cfg.cascade_window_s,
                                  seed=seed + 1, weights=weights)
        if cfg.rack_mtbf_days > 0:
            schedule = merge_schedules(schedule, domain_outage_schedule(
                self.topo, "rack", cfg.rack_mtbf_days, horizon,
                seed=seed + 2))
        self.events = EventQueue(self.clock)
        self.n_injected = push_schedule(self.events, schedule)
        # ONE recovery brain: every shrink-vs-wait/refill decision routes
        # through the shared cost-aware planner (this engine keeps mechanism)
        self.planner = RecoveryPlanner(
            cfg.planner_policy, costs=CostModel.from_soak_policy(self.pol))
        # N-tier hierarchy + adaptive cadence (both off by default: the
        # classic 3-leg waterfall and a fixed interval)
        self.tier_table = default_tiers() if cfg.tiers else None
        self.cadence = (CadenceController(self.pol.ckpt_interval_s,
                                          log=self.planner.log)
                        if cfg.adaptive_cadence else None)

        self.need = cfg.ideal_days * DAY_S   # productive full-fleet seconds
        self.done = 0.0
        self.last_ckpt = 0.0
        self.next_ckpt = self._interval()
        self.lost_s = 0.0
        self.ckpt_overhead_s = 0.0
        self.restarts: List[float] = []
        self.downtime_s = 0.0
        self.restore_sources: Dict[str, int] = {}
        self.ring_n = cfg.n_nodes
        self.counts = dict(job_faults=0, idle_faults=0, absorbed=0,
                           cascades_hit=0, domain_outages=0, shrinks=0,
                           regrows=0, waits_for_repair=0)
        self.wait_s = 0.0
        # Eagle Eye mode: per-category detection latency measured on the
        # streaming scorer itself (deterministic), not drawn from the RNG
        self.stream_tee = None
        if cfg.tee_stream:
            from repro_torch.tee_stream import StreamLatencyModel
            self.stream_tee = StreamLatencyModel()

    # -- fault plumbing -------------------------------------------------- #
    def _victim_of(self, ev: FaultEvent) -> Optional[str]:
        """The machine a fault event lands on, or None if it misses the job.

        Domain events name physical machines; per-node events name fleet
        slots (the machine currently bound to slot i absorbs slot i's
        faults)."""
        if ev.domain is not None:
            node = self.topo.nodes.get(ev.node)
            if node is None or ev.node not in self.topo.assigned:
                return None
            return ev.node if node.state in (NodeState.HEALTHY,
                                             NodeState.DEGRADED) else None
        if not ev.node.startswith("node"):
            return None
        slot = int(ev.node[4:])
        if slot >= len(self.topo.assigned):
            return None
        name = self.topo.assigned[slot]
        node = self.topo.nodes[name]
        return name if node.state in (NodeState.HEALTHY,
                                      NodeState.DEGRADED) else None

    @staticmethod
    def _attributable(ev: FaultEvent) -> bool:
        return (ev.degrades_only or ev.domain is not None
                or ev.category in NODE_ATTRIBUTABLE)

    def _fail(self, name: str, ev: FaultEvent) -> None:
        node = self.topo.nodes[name]
        node.state = (NodeState.DEGRADED if ev.degrades_only
                      else NodeState.FAILED)
        node.fail_category = ev.category
        node.repair_at = self.clock.seconds + self.topo.repair_s

    def _count_hit(self, ev: FaultEvent) -> None:
        if ev.cascade_of is not None:
            self.counts["cascades_hit"] += 1
        if ev.domain is not None:
            self.counts["domain_outages"] += 1

    def _detect_s(self) -> float:
        if self.rng.random() < self.pol.weekend_frac:
            return self.pol.weekend_detect_s
        return float(self.rng.exponential(self.pol.detect_mean_s))

    def _absorb(self, window_s: float, victims: Set[str]) -> None:
        """Advance wall time through a recovery window. Faults landing inside
        are absorbed by the open recovery; attributable ones join ``victims``
        so the same transaction evicts them (the cascading-double-fault path
        that forces the restore down to the persistent store)."""
        end = self.clock.seconds + window_s
        for t, ev in self.events.pop_due(end, advance_clock=True):
            assert self.clock.seconds >= t, \
                f"clock {self.clock.seconds} behind absorbed event at {t}"
            victim = self._victim_of(ev)
            if victim is None:
                self.counts["idle_faults"] += 1
                continue
            self.counts["absorbed"] += 1
            self._count_hit(ev)
            if self._attributable(ev) and victim not in victims:
                self._fail(victim, ev)
                victims.add(victim)

    # -- recovery transaction -------------------------------------------- #
    def _ring_adjacent(self, victims: Set[str]) -> bool:
        """True if two victims were ring neighbours (rank i's backup lives on
        rank i+1, so adjacent deaths wipe a shard's only ring copy)."""
        ranks = sorted(r for r in (self.topo.rank_of_node(v) for v in victims)
                       if r is not None)
        if len(ranks) < 2:
            return False
        n = max(self.ring_n, 2)
        rs = set(ranks)
        return any((r + 1) % n in rs for r in ranks)

    def _refill(self, avoid: Set[str], victims: Set[str],
                incident: Incident) -> None:
        """Bring the fleet back to full strength — *mechanism only*. The
        claim-vs-shrink-vs-wait choice is the shared RecoveryPlanner's; this
        method executes the planned ladder through the topology's claim API
        (spares first, then repaired machines) and the event queue (waits
        absorb faults into the open transaction)."""
        cfg, topo = self.cfg, self.topo
        floor = max(1, math.ceil(cfg.shrink_threshold * cfg.n_nodes))

        def _cstate() -> ClusterState:
            topo.repair_due(self.clock.seconds)
            return ClusterState(
                n_assigned=len(topo.assigned),
                n_target=cfg.n_nodes,
                min_nodes=floor if cfg.shrink_threshold > 0 else cfg.n_nodes,
                free_supply=topo.claimable_supply(),
                repair_eta_s=self._next_repair_wait(),
                has_ring_backup=self.pol.has_ring_backup,
                progress_at_risk_s=self.done - self.last_ckpt)

        def _claim() -> bool:
            return topo.schedule_replacement(set(), avoid_domains=avoid) \
                is not None

        def _shrink() -> None:
            self.counts["shrinks"] += 1

        def _wait() -> Optional[bool]:
            wait = self._next_repair_wait()
            if wait is None:
                return False
            self.counts["waits_for_repair"] += 1
            self.wait_s += wait
            self._absorb(wait, victims)
            return True

        fill_slots(self.planner, incident, _cstate,
                   RecoveryExecutor(
                       missing=lambda: cfg.n_nodes - len(topo.assigned),
                       try_claim=_claim, do_shrink=_shrink, do_wait=_wait))

    def _next_repair_wait(self) -> Optional[float]:
        due = self.topo.next_repair_at()
        if due is None:
            return None
        return max(due - self.clock.seconds, 1.0)

    def _interval(self) -> float:
        """The save cadence in force right now (adaptive or fixed)."""
        return (self.cadence.interval_s if self.cadence is not None
                else self.pol.ckpt_interval_s)

    def _tiers_down(self) -> Set[str]:
        """Tiers unavailable at this modelled instant (NAS brownouts)."""
        down: Set[str] = set()
        t = self.clock.seconds
        for start, dur in self.cfg.nas_outages:
            if start <= t < start + dur:
                down.add(TIER_NAS)
        return down

    def _restore_source(self, *, inplace: bool, escalated: bool,
                        rack_corr: bool) -> str:
        """The planner's restore leg for this recovery — tier-ranked over
        the full hierarchy when tiers are on, the classic 3-leg waterfall
        otherwise. Never hardcodes a tier order (grep-gated in CI)."""
        if self.tier_table is None:
            return self.planner.choose_restore_source(
                inplace=inplace, escalated=escalated,
                has_ring_backup=self.pol.has_ring_backup)
        down = self._tiers_down()
        if rack_corr:
            down.update(self.tier_table.correlated("rack"))
        plan = self.planner.choose_restore_plan(
            self.tier_table, inplace=inplace, escalated=escalated,
            has_ring_backup=self.pol.has_ring_backup, down=down)
        return plan.source

    def _recover(self, victims: Set[str],
                 ev: Optional[FaultEvent] = None) -> None:
        """One recovery transaction on the shared clock: detection/checks ->
        (evict -> refill -> reschedule)* -> restore -> warm-up. ``victims``
        empty means no node was attributable (in-place restart)."""
        pol, topo = self.pol, self.topo
        t0 = self.clock.seconds
        wait0 = self.wait_s
        n_prev = len(topo.assigned)
        if self.stream_tee is not None and ev is not None:
            detect_s = self.stream_tee.latency_s(ev.category,
                                                 ev.degrades_only)
        else:
            detect_s = self._detect_s()
        self._absorb(detect_s + pol.error_check_s, victims)

        processed: Set[str] = set()
        mid_restore_join = False
        adjacent = False
        # a whole-rack outage (domain event) or 2+ victims in one rack is a
        # correlated loss: the rack-scoped tiers (peer ring, burst-buffer
        # ssd) must be assumed gone along with the machines
        rack_corr = ev is not None and ev.domain is not None
        while victims - processed:
            fresh = sorted(victims - processed)
            adjacent = adjacent or self._ring_adjacent(victims)
            # 2+ victims in one rack points at a correlated root cause:
            # keep replacements out of that failure domain
            rack_hits = Counter(topo.domain_of(v) for v in fresh)
            avoid = {r for r, c in rack_hits.items() if c >= 2}
            rack_corr = rack_corr or bool(avoid)
            for v in fresh:
                topo.evict(v, self.clock.seconds)
            if processed:
                mid_restore_join = True
            processed |= set(fresh)
            self._refill(avoid, victims,
                         Incident("fault", self.clock.seconds,
                                  victims=tuple(fresh),
                                  mid_recovery_join=mid_restore_join,
                                  ring_adjacent=adjacent))
            self._absorb(pol.evict_reschedule_s, victims)

        if not processed:                         # in-place restart
            self.planner.plan(
                Incident("fault", self.clock.seconds),
                ClusterState(n_assigned=len(topo.assigned),
                             n_target=len(topo.assigned), min_nodes=1,
                             has_ring_backup=pol.has_ring_backup,
                             progress_at_risk_s=self.done - self.last_ckpt))
            source = self._restore_source(inplace=True, escalated=False,
                                          rack_corr=False)
            self.clock.advance(pol.inplace_restart_s)
        else:
            n_after = len(topo.assigned)
            if n_after > n_prev:
                self.counts["regrows"] += 1
            # which waterfall leg serves this restore is the planner's call
            source = self._restore_source(
                inplace=False,
                escalated=(mid_restore_join or adjacent
                           or n_after != n_prev),
                rack_corr=rack_corr)
        # one cost table: the same CostModel the planner scored with
        cost = self.planner.costs.restore_s(source)
        self.clock.advance(cost + pol.warmup_s)
        topo.rebind_ranks(list(topo.assigned))
        self.ring_n = max(len(topo.assigned), 1)

        if self.cadence is not None:
            # rollback cost of this recovery = work thrown away + the
            # restore leg it forced; rising costs tighten the cadence
            self.cadence.observe_incident(
                self.clock.seconds, (self.done - self.last_ckpt) + cost)
        self.restore_sources[source] = self.restore_sources.get(source, 0) + 1
        self.lost_s += self.done - self.last_ckpt
        self.done = self.last_ckpt
        self.next_ckpt = self.done + self._interval()
        # restart latency is the recovery *machinery* (detect, checks,
        # reschedule, restore, warm-up) — repair-capacity stalls (waiting for
        # a machine to come back) are reported separately as repair_wait_s
        self.restarts.append(self.clock.seconds - t0
                             - (self.wait_s - wait0))
        self.downtime_s += self.clock.seconds - t0

    def _handle_incident(self, evs: List[FaultEvent]) -> None:
        """Dispatch one incident: a single fault, or every member event of a
        same-(t, domain) correlated outage coalesced into one recovery
        transaction. Equivalent to handling the members one at a time — the
        follow-on members would land inside the detection window and be
        absorbed into the same transaction anyway (pinned by test)."""
        victims: Set[str] = set()
        opened = False
        first_ev: Optional[FaultEvent] = None
        for ev in evs:
            victim = self._victim_of(ev)
            if victim is None:
                self.counts["idle_faults"] += 1
                continue
            self._count_hit(ev)
            if not opened:
                self.counts["job_faults"] += 1
                opened = True
                first_ev = ev
            else:
                self.counts["absorbed"] += 1
            if self._attributable(ev) and victim not in victims:
                self._fail(victim, ev)
                victims.add(victim)
        if opened:
            self._recover(victims, first_ev)

    def _handle_fault(self, ev: FaultEvent) -> None:
        self._handle_incident([ev])

    # -- main loop -------------------------------------------------------- #
    def run(self) -> dict:
        cfg, pol, clock, events = self.cfg, self.pol, self.clock, self.events
        guard = 0
        while self.done < self.need:
            guard += 1
            if guard > 2_000_000:
                raise RuntimeError("soak loop did not converge")
            speed = len(self.topo.assigned) / cfg.n_nodes
            if speed <= 0:      # whole fleet down: stall until a repair lands
                wait = self._next_repair_wait()
                if wait is None:
                    raise RuntimeError("empty fleet with nothing repairing")
                victims: Set[str] = set()
                self._absorb(wait, victims)
                self.topo.repair_due(clock.seconds)
                self._refill(set(), victims,
                             Incident("repair", clock.seconds))
                self.topo.rebind_ranks(list(self.topo.assigned))
                self.ring_n = max(len(self.topo.assigned), 1)
                continue
            run_prod = min(self.next_ckpt - self.done, self.need - self.done)
            run_wall = run_prod / speed
            t_fault_wall = events.peek_time() - clock.seconds
            if events and t_fault_wall <= run_wall:
                t_fault_wall = max(t_fault_wall, 0.0)
                t, ev = events.pop(advance_clock=True)
                assert clock.seconds >= t, \
                    f"clock {clock.seconds} behind popped event at {t}"
                self.done += t_fault_wall * speed
                batch = [ev]
                if COALESCE_INCIDENTS and isinstance(ev, FaultEvent) \
                        and ev.domain is not None:
                    # drain this outage's same-(t, domain) siblings (stable
                    # FIFO order) so the whole incident is one transaction
                    while events and events.peek_time() == t:
                        nxt = events.peek()[1]
                        if not (isinstance(nxt, FaultEvent)
                                and nxt.domain == ev.domain):
                            break
                        batch.append(events.pop(advance_clock=True)[1])
                self._handle_incident(batch)
            else:
                clock.advance(run_wall)
                self.done += run_prod
                if self.done >= self.need:
                    break
                clock.advance(pol.ckpt_save_stall_s)
                self.ckpt_overhead_s += pol.ckpt_save_stall_s
                self.last_ckpt = self.done
                self.next_ckpt = self.done + self._interval()
        return self._report()

    def _report(self) -> dict:
        cfg, pol = self.cfg, self.pol
        elapsed = max(self.clock.seconds, 1e-9)
        c = self.counts
        return {
            "engine": "soak",
            "policy": pol.name,
            "seed": self.seed,
            "config": {
                "ideal_days": cfg.ideal_days,
                "n_nodes": cfg.n_nodes,
                "n_spares": cfg.n_spares,
                "mtbf_node_days": cfg.mtbf_node_days,
                "shrink_threshold": cfg.shrink_threshold,
                "ckpt_interval_s": pol.ckpt_interval_s,
                "p_cascade": cfg.p_cascade,
                "rack_mtbf_days": cfg.rack_mtbf_days,
                # only stamped when on: default report shape stays pinned
                **({"tee_stream": True} if cfg.tee_stream else {}),
                **({"tiers": True} if cfg.tiers else {}),
                **({"adaptive_cadence": True}
                   if cfg.adaptive_cadence else {}),
                **({"nas_outages": [list(o) for o in cfg.nas_outages]}
                   if cfg.nas_outages else {}),
            },
            **({"cadence": self.cadence.to_report()}
               if self.cadence is not None else {}),
            "end_to_end_days": round(elapsed / DAY_S, 4),
            "effective_time_ratio": round(self.need / elapsed, 4),
            "lost_steps": int(round(self.lost_s / cfg.step_time_s)),
            "lost_compute_days": round(self.lost_s / DAY_S, 4),
            "ckpt_overhead_days": round(self.ckpt_overhead_s / DAY_S, 4),
            "restore_sources": dict(sorted(self.restore_sources.items())),
            "recovery": {
                "restarts": len(self.restarts),
                "mean_restart_s": round(float(np.mean(self.restarts)), 1)
                if self.restarts else 0.0,
                "total_downtime_s": round(self.downtime_s, 1),
                "waits_for_repair": c["waits_for_repair"],
                "repair_wait_s": round(self.wait_s, 1),
            },
            "faults": {
                "injected": self.n_injected,
                "hit_job": c["job_faults"],
                "idle": c["idle_faults"],
                "absorbed_in_recovery": c["absorbed"],
                "cascades": c["cascades_hit"],
                "domain_outages": c["domain_outages"],
                "unfired_at_completion": len(self.events),
            },
            "fleet": {
                "shrinks": c["shrinks"],
                "regrows": c["regrows"],
                "final_active": len(self.topo.assigned),
            },
            # the RecoveryPlanner's structured decision log (full counts,
            # entries capped deterministically to bound sweep artifacts)
            "decisions": self.planner.log.to_report(cap=40),
            "one_clock": (self.topo.clock is self.clock
                          and self.events.clock is self.clock),
        }


def run_soak(cfg: SoakConfig, seed: Optional[int] = None) -> dict:
    """Run one time-triggered soak and return its deterministic JSON report.

    ``seed`` overrides ``cfg.seed``; the fault environment depends only on
    the cluster/fault knobs and the seed (not the policy), so two policies
    at the same seed face the same fault timeline.
    """
    from repro_torch.report import finalize

    use_seed = cfg.seed if seed is None else seed
    return finalize(_SoakRun(cfg, use_seed).run(), engine="soak",
                    seed=use_seed)


def run_multi_job_soak(job_sizes=(8, 8), ideal_days: float = 7.0,
                       n_nodes: int = 16, n_spares: int = 4,
                       nodes_per_rack: int = 8,
                       mtbf_node_days: float = 110.0,
                       p_cascade: float = 0.1,
                       rack_mtbf_days: float = 0.0,
                       repair_hours: float = 24.0,
                       ckpt_interval_s: float = 1800.0,
                       preemption: bool = True,
                       seed: int = 0) -> dict:
    """The soak engine's **multi-job mode**: the same long-horizon stochastic
    fault environment (Table-I mix, cascades, whole-rack outages), but with
    ``len(job_sizes)`` concurrent jobs gang-scheduled onto ONE topology and
    arbitrating one spare pool. Delegates to :mod:`repro.fleet.engine`;
    returns its per-job + fleet-level goodput report.

    Jobs are named ``job0..jobN-1``; earlier entries get higher priority
    (job0 is the flagship, later jobs are preemption donors).
    """
    from repro_torch.fleet.engine import FleetConfig, run_fleet
    from repro_torch.fleet.scheduler import JobSpec

    jobs = tuple(
        JobSpec(f"job{i}", int(size), priority=len(job_sizes) - i,
                ideal_hours=ideal_days * 24.0,
                min_nodes=max(2, int(size) // 2),
                ckpt_interval_s=ckpt_interval_s)
        for i, size in enumerate(job_sizes))
    cfg = FleetConfig(
        jobs=jobs, n_nodes=n_nodes, n_spares=n_spares,
        nodes_per_rack=nodes_per_rack, repair_hours=repair_hours,
        preemption=preemption, mtbf_node_days=mtbf_node_days,
        p_cascade=p_cascade, rack_mtbf_days=rack_mtbf_days,
        horizon_days=ideal_days * 8.0, seed=seed)
    return run_fleet(cfg, seed=seed)
