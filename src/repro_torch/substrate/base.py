"""The Substrate protocol: one surface for simulated and real training.

A *substrate* is the thing the fault-tolerance stack (TOL orchestration,
TEE attribution, the shared :class:`repro.recovery.RecoveryPlanner`) keeps
alive. Two interchangeable implementations exist:

* :class:`repro.substrate.sim.SimSubstrate` — the full TRANSOM stack on the
  unified simulation substrate (one SimClock, one Topology, modelled work).
  This is the moved-and-promoted ``Substrate`` bundle that used to live in
  ``repro.sim.scenarios``.
* :class:`repro.substrate.process.ProcessSubstrate` — actual multi-process
  PyTorch ranks (``python -m repro.substrate.worker`` subprocesses running the
  real trainer on CPU), checkpointing real pytrees through the TCE
  ``DiskStore`` datapath, with faults injected by SIGKILLing live rank
  processes.

The driver (:mod:`repro.substrate.driver`) runs TOL/TEE/planner recovery
against this protocol only — by design there is no ``isinstance`` dispatch
anywhere in the loop, so everything proven on the simulated substrate holds
verbatim for real processes.

Contract notes shared by both implementations:

* ``kill`` takes effect at the next ``step_metrics`` boundary: training is
  synchronous data-parallel, so a dead rank surfaces as a failed step, not
  as an async event.
* ``save_via_tce`` is atomic-at-manifest: a checkpoint either becomes
  visible complete (every rank's shards durable) or not at all. A rank
  dying mid-save can never produce a torn restore.
* ``restore_via_tce`` returns the step to resume from (0 = from scratch)
  and leaves every surviving/new rank holding the restored state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable


@dataclass(frozen=True)
class RankHealth:
    """One rank's liveness as seen by the substrate."""
    rank: int
    node: str
    alive: bool
    detail: str = ""


@dataclass(frozen=True)
class FaultNotice:
    """A fault surfaced by ``step_metrics``: which ranks died, and the
    injected category per dead rank (the substrate knows what it injected;
    TEE's job is to *attribute* it independently from traces)."""
    step: int                      # last fully completed step
    dead_ranks: Tuple[int, ...]
    categories: Dict[int, str] = field(default_factory=dict)


@dataclass
class StepSlice:
    """Result of one ``step_metrics`` call: progress up to ``step``, the
    latest training metrics, and — if the slice was interrupted — the fault.
    ``losses`` carries the per-step ``[step, loss]`` series for the slice
    (the loss-curve-continuity contract is asserted over it)."""
    step: int
    metrics: Dict[str, float] = field(default_factory=dict)
    losses: List[List[float]] = field(default_factory=list)
    fault: Optional[FaultNotice] = None

    @property
    def ok(self) -> bool:
        return self.fault is None


@runtime_checkable
class Substrate(Protocol):
    """What TOL/TEE/planner require of a training substrate.

    Implementations also expose ``clock`` (SimClock), ``topology``
    (Topology) and ``server`` (TransomServer) — the shared control-plane
    state the recovery loop reads and writes.
    """

    n_ranks: int
    job_id: str
    device: object      # where the ranks and the error checks run

    def start_ranks(self,
                    assignments: Optional[Dict[int, str]] = None) -> None:
        """(Re)start ranks. ``assignments`` maps rank -> node for ranks that
        move to a replacement node; ranks not listed restart where bound."""
        ...

    def health(self) -> List[RankHealth]:
        """Liveness of every rank, in rank order."""
        ...

    def kill(self, rank: int, category: str = "node_hw") -> None:
        """Inject a fault: kill the given rank (SIGKILL for real processes,
        FAILED node state for simulation). Takes effect at the next
        ``step_metrics`` boundary."""
        ...

    def stall(self, rank: int, stall_s: float = 1.5) -> None:
        """Inject a straggler: freeze the given rank for ``stall_s`` during
        the next training slice (SIGSTOP/SIGCONT for real processes,
        modelled extra wall time for simulation). The slice still succeeds;
        the slowdown surfaces in ``last_rank_walls`` for the streaming TEE
        to attribute."""
        ...

    def save_via_tce(self, step: int) -> bool:
        """Checkpoint through the TCE datapath. True iff the checkpoint
        became durable (manifest committed)."""
        ...

    def restore_via_tce(self) -> int:
        """Restore every rank from the freshest recoverable checkpoint.
        Returns the step to resume from (0 = no checkpoint, from scratch)."""
        ...

    def prefetch_restore(self) -> Optional[int]:
        """Speculatively stage the freshest recoverable checkpoint for the
        next ``restore_via_tce`` while recovery overhead (error checks,
        reschedule, process restarts) runs — the simulated substrate starts
        a modelled tier read whose residual the restore pays, the process
        substrate warms the OS page cache controller-side. Returns the
        staged step, or None when nothing could be staged. Purely a
        latency hint: restore correctness never depends on it."""
        ...

    def step_metrics(self, upto: int) -> StepSlice:
        """Train from the current step up to (exclusive) ``upto``. Returns
        the slice result; if a rank died, ``fault`` is set and ``step`` is
        the last step whose update fully completed on the survivors."""
        ...

    def close(self) -> None:
        ...
