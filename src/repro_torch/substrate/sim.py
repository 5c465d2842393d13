"""SimSubstrate: the full TRANSOM stack on the unified simulation substrate.

This is the promoted ``Substrate`` bundle that used to live in
``repro.sim.scenarios`` (which still re-exports it for back-compat): one
:class:`SimClock`, one :class:`Topology`, one fault model, with TCE/TEE/TOL
wired on top. It also implements the :class:`repro.substrate.base.Substrate`
protocol methods so the same recovery driver that keeps real processes
alive (:mod:`repro.substrate.driver`) drives the modelled cluster too.

Two ways to run it:

* the **closed-loop** path (``sub.operator.run_job``) — the historical
  scenario engine, unchanged;
* the **protocol** path (``start_ranks / kill / step_metrics /
  save_via_tce / restore_via_tce``) — modelled work stepped by the shared
  driver, interchangeable with :class:`ProcessSubstrate`.

Counterpart of ``repro.substrate.sim``; the port's departure is ``device``:
``build_sim_substrate(device=None)`` resolves it (the card unless ``"cpu"``
is asked for) before anything is built and hands it to the operator, whose
warm-up and error-check burn-ins are the modelled cluster's only device
work; ``SimSubstrate.device`` is the operator's, for the shared driver.
"""
from __future__ import annotations

import copy
import functools
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.sim.clock import SimClock
from repro_torch.sim.topology import NodeState, Topology

from .base import FaultNotice, RankHealth, StepSlice

# modelled work for the protocol path: state evolves deterministically and
# the loss is a pure function of the step index, so rewind-and-replay after
# a restore reproduces the uninterrupted loss curve exactly (the same
# contract the real trainer meets bit-for-bit in ProcessSubstrate)
def _default_state(n: int = 256) -> Dict[str, np.ndarray]:
    return {"w": np.zeros((n,), np.float32),
            "opt/m": np.zeros((n,), np.float32)}


def _default_step(state: Dict[str, np.ndarray],
                  step: int) -> Tuple[Dict[str, np.ndarray], Dict[str, float]]:
    new = {"w": state["w"] + 1.0, "opt/m": state["opt/m"] * 0.9 + 0.1}
    return new, {"loss": round(4.0 * 0.98 ** step, 6)}


@dataclass
class SimSubstrate:
    """The full TRANSOM stack wired onto one clock / topology / fault model."""
    clock: SimClock
    topology: Topology
    fabric: "object"          # repro.core.tce.transport.Fabric
    store: "object"           # repro.core.tce.store.NASStore
    tce: "object"             # repro.core.tce.engine.TCEngine
    tee: Optional["object"]   # repro.core.tee.service.TEEService
    server: "object"          # repro.core.tol.server.TransomServer
    operator: "object"        # repro.core.tol.orchestrator.TransomOperator

    # --- protocol-path state -------------------------------------------- #
    job_id: str = "job0"
    step_time_s: float = 1.0
    _step: int = 0
    _state: Optional[Dict[str, np.ndarray]] = None
    _step_fn: Optional[Callable] = None
    _init_state: Optional[Dict[str, np.ndarray]] = None
    _pending: Dict[int, str] = field(default_factory=dict)
    _stall_next: Dict[int, float] = field(default_factory=dict)
    _prefetch: Optional["object"] = None   # in-flight PrefetchHandle
    last_rank_walls: Dict[int, float] = field(default_factory=dict)

    @property
    def device(self):
        return self.operator.device

    @property
    def n_ranks(self) -> int:
        return self.tce.cfg.n_nodes

    def clock_identity_ok(self) -> bool:
        """True iff every subsystem ticks on the *same* SimClock object."""
        clocks = [self.operator.clock, self.tce.clock, self.fabric.clock,
                  self.store.clock, self.topology.clock,
                  self.tce.reconciler.clock]
        return all(c is self.clock for c in clocks)

    def close(self) -> None:
        # the operator may have rebuilt the engine (elastic shrink/grow);
        # close the live one, not the original handle
        self.operator.tce.close()
        if self.tce is not self.operator.tce:
            self.tce.close()

    # ------------------------------------------------------------------ #
    # Substrate protocol (the shared-driver path)
    # ------------------------------------------------------------------ #
    def attach_work(self, state: Dict[str, np.ndarray],
                    step_fn: Callable) -> None:
        """Install the modelled work: ``step_fn(state, step) ->
        (state, metrics)``. Defaults are installed by ``start_ranks`` if
        nothing was attached."""
        self._state = state
        self._init_state = copy.deepcopy(state)
        self._step_fn = step_fn

    def start_ranks(self,
                    assignments: Optional[Dict[int, str]] = None) -> None:
        if self._state is None:
            self.attach_work(_default_state(), _default_step)
        if self.topology.node_of_rank(0) is None and not assignments:
            for rank, node in enumerate(self.topology.assigned):
                self.topology.bind_rank(rank, node)
            return
        for rank, node in (assignments or {}).items():
            self.topology.bind_rank(rank, node)
            # a fresh machine joins the ring: pull its cache back from the
            # ring neighbour's backups, exactly like the closed-loop path
            self.tce.node_recovered(rank, fresh=True)

    def health(self) -> List[RankHealth]:
        out = []
        for rank in range(self.n_ranks):
            node = self.topology.node_of_rank(rank)
            down = self.topology.is_rank_down(rank)
            out.append(RankHealth(rank, node or "?", alive=not down,
                                  detail="" if not down else "node down"))
        return out

    def kill(self, rank: int, category: str = "node_hw") -> None:
        node = self.topology.node_of_rank(rank)
        if node is not None and node in self.topology.nodes:
            n = self.topology.nodes[node]
            n.state = NodeState.FAILED
            n.fail_category = category
        self.tce.node_failed(rank)
        self._pending[rank] = category

    def stall(self, rank: int, stall_s: float = 1.5) -> None:
        """Modelled straggler: the rank's next slice takes ``stall_s``
        extra wall time (the SIGSTOP/SIGCONT counterpart on real ranks)."""
        self._stall_next[rank] = self._stall_next.get(rank, 0.0) + stall_s

    def step_metrics(self, upto: int) -> StepSlice:
        start = self._step
        metrics: Dict[str, float] = {}
        losses: List[List[float]] = []
        while self._step < upto:
            if self._pending:
                notice = FaultNotice(step=self._step,
                                     dead_ranks=tuple(sorted(self._pending)),
                                     categories=dict(self._pending))
                self._pending.clear()
                return StepSlice(self._step, metrics, losses, fault=notice)
            self._state, metrics = self._step_fn(self._state, self._step)
            self._step += 1
            if "loss" in metrics:
                losses.append([self._step, metrics["loss"]])
            self.clock.advance(self.step_time_s)
        base = self.step_time_s * max(self._step - start, 0)
        self.last_rank_walls = {r: base + self._stall_next.get(r, 0.0)
                                for r in range(self.n_ranks)}
        if self._stall_next:
            # synchronous data-parallel: the job pays the slowest rank
            self.clock.advance(max(self._stall_next.values()))
            self._stall_next.clear()
        return StepSlice(self._step, metrics, losses)

    def save_via_tce(self, step: int) -> bool:
        self.tce.save(step, self._state)
        return True

    def prefetch_restore(self) -> Optional[int]:
        self.tce.reconciler.quiesce(10)
        try:
            self._prefetch = self.tce.prefetch_restore()
        except (FileNotFoundError, AttributeError):
            self._prefetch = None
        return None if self._prefetch is None else int(self._prefetch.step)

    def restore_via_tce(self) -> int:
        self.tce.reconciler.quiesce(10)
        pf, self._prefetch = self._prefetch, None
        try:
            ck_step, flat = self.tce.restore(prefetch=pf)
        except FileNotFoundError:
            self._state = copy.deepcopy(self._init_state)
            self._step = 0
            return 0
        self._state = dict(flat)
        self._step = int(ck_step)
        return self._step


@functools.lru_cache(maxsize=4)
def _fitted_tee(n_ranks: int, seed: int = 1):
    """TEE model ensemble fitted on normal traces (cached: deterministic and
    shared across scenario runs in one process)."""
    from repro_torch.core.tee import OfflineTrainer, TraceGenerator

    gen = TraceGenerator(n_ranks=n_ranks, seed=seed)
    return OfflineTrainer().fit([gen.normal() for _ in range(8)])


def build_sim_substrate(n_nodes: int = 4, n_spares: int = 4,
                        nodes_per_rack: int = 2,
                        store_root: Optional[str] = None,
                        with_tee: bool = True, verbose: bool = False,
                        nas_bw: float = 1e9, device=None) -> SimSubstrate:
    """Build the full closed-loop stack on a single shared clock/topology.

    This is THE way to stand up TRANSOM-in-simulation: tests, benchmarks and
    examples all come through here so there is exactly one SimClock and one
    Topology per run (asserted by ``SimSubstrate.clock_identity_ok``).
    """
    from repro_torch.core.tce import NASStore, TCEConfig, TCEngine
    from repro_torch.core.tce.transport import Fabric
    from repro_torch.core.tee import TEEService
    from repro_torch.core.tol import TransomOperator, TransomServer

    device = resolve_device(device)
    clock = SimClock()
    topology = Topology(n_nodes, n_spares=n_spares,
                        nodes_per_rack=nodes_per_rack, clock=clock)
    store = NASStore(store_root or tempfile.mkdtemp(prefix="transom_sim_"),
                     bw_per_rank=nas_bw, clock=clock)
    fabric = Fabric(clock=clock, topology=topology)
    tce = TCEngine(TCEConfig(n_nodes=n_nodes), store, fabric=fabric,
                   clock=clock, topology=topology)
    tee = TEEService(_fitted_tee(n_ranks=n_nodes)) if with_tee else None
    server = TransomServer()
    operator = TransomOperator(server, topology, tce, tee, clock=clock,
                               verbose=verbose, device=device)
    return SimSubstrate(clock, topology, fabric, store, tce, tee, server,
                        operator)
