"""Fleet scheduler: gang scheduling, pending queue, priorities, preemption.

One :class:`FleetScheduler` owns admission onto a shared multi-job
:class:`~repro.sim.topology.Topology` (built with ``auto_assign=False``):

* **gang scheduling** — a job is admitted only when its *whole* node request
  can be claimed at once (all-or-nothing; partial claims are rolled back);
* **pending queue** — jobs that don't fit wait, ordered by priority then
  submission order, and are re-considered whenever capacity frees up
  (job completion, repairs landing);
* **preemption donors** — when a high-priority job's recovery finds the
  shared spare pool dry, the scheduler *names* the lowest-priority running
  job that can be elastically shrunk to donate a machine. Whether to take
  that rung at all is not decided here: the shared
  :class:`repro.recovery.RecoveryPlanner` owns the claim-vs-preempt-vs-
  shrink-vs-wait decision; this scheduler is pure mechanism.

The scheduler only moves leases; modelled time, recovery costs and fault
handling live in :mod:`repro.fleet.engine`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from repro_torch.sim.soak import SoakPolicy, transom_policy
from repro_torch.sim.topology import Topology

from .view import JobView


@dataclass(frozen=True)
class JobSpec:
    """One training job's request against the fleet."""
    name: str
    n_nodes: int
    priority: int = 0               # higher preempts lower
    ideal_hours: float = 6.0        # productive compute at full gang size
    min_nodes: int = 2              # elastic floor (== n_nodes: cannot shrink)
    ckpt_interval_s: float = 1800.0  # cadence, in productive seconds
    ckpt_bytes: float = 8e9         # checkpoint size -> NAS flow length
    step_time_s: float = 30.0       # one training step, for lost_steps
    submit_at_s: float = 0.0        # when the job enters the queue
    policy: SoakPolicy = field(default_factory=transom_policy)

    def __post_init__(self):
        if not (1 <= self.min_nodes <= self.n_nodes):
            raise ValueError(
                f"{self.name}: need 1 <= min_nodes <= n_nodes, "
                f"got {self.min_nodes}/{self.n_nodes}")


class FleetScheduler:
    """Claim-based admission + arbitration for N jobs on one topology."""

    def __init__(self, topology: Topology):
        assert not topology.assigned, \
            "fleet topology must be built with auto_assign=False"
        self.topo = topology
        self.pending: List[JobSpec] = []
        self.views: Dict[str, JobView] = {}
        self._submit_order: Dict[str, int] = {}
        self.stats = {"admitted": 0, "queued": 0, "claims_granted": 0,
                      "claims_denied": 0, "preemption_donations": 0}

    # -- admission -------------------------------------------------------- #
    def submit(self, spec: JobSpec) -> Optional[JobView]:
        """Queue a job and try to admit it. Returns its view if it was gang-
        scheduled immediately, else None (job waits in the pending queue)."""
        if spec.name in self.views or any(p.name == spec.name
                                          for p in self.pending):
            raise ValueError(f"duplicate job name {spec.name!r}")
        self._submit_order[spec.name] = len(self._submit_order)
        self.pending.append(spec)
        self.stats["queued"] += 1
        admitted = self.try_admit()
        return self.views.get(spec.name) if spec.name in \
            {s.name for s in admitted} else None

    def _queue_key(self, spec: JobSpec):
        return (-spec.priority, self._submit_order[spec.name])

    def submit_order(self, name: str) -> int:
        """Submission index of a job — the deterministic tie-break the
        engine's regrow pass shares with admission ordering."""
        return self._submit_order.get(name, 0)

    def try_admit(self) -> List[JobSpec]:
        """Admit every pending job whose full gang fits, highest priority
        first (all-or-nothing per job). Returns the admitted specs.

        Early-outs when the queue is empty: the fleet engine calls this on
        every control tick, and at steady state (all jobs admitted) the call
        must not pay the ``free_nodes()`` scan."""
        if not self.pending:
            return []
        admitted: List[JobSpec] = []
        for spec in sorted(self.pending, key=self._queue_key):
            free = self.topo.free_nodes()
            if len(free) < spec.n_nodes:
                continue
            granted = [self.topo.claim_specific(n, spec.name)
                       for n in free[:spec.n_nodes]]
            self.views[spec.name] = JobView(self.topo, spec.name, granted)
            self.pending.remove(spec)
            admitted.append(spec)
            self.stats["admitted"] += 1
        return admitted

    def complete(self, name: str) -> None:
        """A job finished: release its surviving leases back to the pool."""
        view = self.views.pop(name, None)
        if view is None:
            return
        for n in list(view.assigned):
            view.release(n)

    # -- replacement arbitration ------------------------------------------ #
    def claim_replacement(self, name: str, anti_affinity: Set[str],
                          avoid_domains=()) -> Optional[str]:
        """One job asks for a replacement machine from the shared pool."""
        view = self.views[name]
        got = view.schedule_replacement(anti_affinity, avoid_domains)
        self.stats["claims_granted" if got else "claims_denied"] += 1
        return got

    def find_donor(self, requester: JobSpec,
                   specs: Dict[str, JobSpec],
                   donatable: Set[str]) -> Optional[str]:
        """Lowest-priority running job (strictly below the requester) that
        can shrink by one node without crossing its elastic floor.
        ``donatable`` limits candidates to jobs the engine considers safely
        shrinkable right now (running/stalled, not mid-recovery)."""
        cands = []
        for jname, view in self.views.items():
            if jname == requester.name or jname not in donatable:
                continue
            spec = specs[jname]
            if spec.priority >= requester.priority:
                continue
            if len(view.assigned) - 1 < spec.min_nodes:
                continue
            cands.append((spec.priority, self._submit_order[jname], jname))
        if not cands:
            return None
        cands.sort()
        return cands[0][2]

    def donate(self, donor: str, requester: str) -> str:
        """Move one healthy machine from ``donor`` to ``requester``'s view.
        The lease is reassigned atomically — never observable as free."""
        donor_view, req_view = self.views[donor], self.views[requester]
        healthy = [n for n in donor_view.assigned
                   if self.topo.nodes[n].state.value == "healthy"]
        assert healthy, f"donor {donor!r} has no healthy node to give"
        node = healthy[-1]          # shed the highest-rank machine
        donor_view.assigned.remove(node)
        # the donor's fabric view must not keep reading the donated
        # machine's health as one of its own ranks
        donor_view.rebind_ranks(donor_view.assigned)
        self.topo.reassign_lease(node, requester)
        req_view.assigned.append(node)
        self.stats["preemption_donations"] += 1
        return node
