"""Per-job lens over the shared fleet :class:`~repro.sim.topology.Topology`.

A :class:`JobView` presents the single-job ClusterSim interface (``assigned``,
``evict``, ``schedule_replacement``, rank binding) that
:class:`~repro.core.tol.orchestrator.TransomOperator`, the TOL task suites and
TCE's fabric all consume — but scoped to one job's leased nodes on a topology
hosting many jobs. Replacement picks go through the topology's claim ledger
under the view's ``job_id``, so two jobs recovering concurrently can never be
handed the same spare (:class:`~repro.sim.topology.DoubleGrantError` guards
the invariant).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

from repro_torch.sim.topology import NodeState, Topology


class JobView:
    """One job's slice of a shared multi-job topology."""

    def __init__(self, topology: Topology, job_id: str,
                 nodes: Iterable[str]):
        self.topo = topology
        self.job_id = job_id
        self.assigned: List[str] = list(nodes)
        for n in self.assigned:
            owner = topology.owner_of(n)
            assert owner == job_id, \
                f"{n} leased to {owner!r}, view belongs to {job_id!r}"
        self._rank_map: Dict[int, str] = dict(enumerate(self.assigned))
        self._node_rank: Dict[str, int] = {
            n: r for r, n in self._rank_map.items()}

    # -- shared-substrate passthrough ----------------------------------- #
    @property
    def clock(self):
        return self.topo.clock

    @property
    def nodes(self):
        return self.topo.nodes

    @property
    def repair_s(self) -> float:
        return self.topo.repair_s

    def domain_of(self, node: str, kind: str = "rack") -> str:
        return self.topo.domain_of(node, kind)

    def domain_members(self, kind: str, name: str) -> List[str]:
        return self.topo.domain_members(kind, name)

    def repair_due(self, t: float) -> None:
        self.topo.repair_due(t)

    # -- scheduling (claim-arbitrated) ----------------------------------- #
    def evict(self, name: str, t: float) -> None:
        """Cordon + release the lease; the machine returns to the shared
        repair queue, claimable by any job once repaired."""
        self.topo.cordon(name, t)
        self.topo.release_node(name, self.job_id)
        if name in self.assigned:
            self.assigned.remove(name)

    def release(self, name: str) -> None:
        """Give a healthy node back to the shared pool (job completion or a
        preemption donation) without cordoning it."""
        self.topo.release_node(name, self.job_id)
        if name in self.assigned:
            self.assigned.remove(name)

    def schedule_replacement(self, anti_affinity: Set[str],
                             avoid_domains: Iterable[str] = (),
                             claimant: Optional[str] = None
                             ) -> Optional[str]:
        assert claimant in (None, self.job_id), \
            f"view of {self.job_id!r} cannot claim for {claimant!r}"
        name = self.topo.claim_replacement(self.job_id, anti_affinity,
                                           avoid_domains)
        if name is not None:
            self.assigned.append(name)
        return name

    def claimable_supply(self, anti_affinity: Set[str] = frozenset()) -> int:
        """Shared-pool supply visible to this job's planner snapshot."""
        return self.topo.claimable_supply(anti_affinity)

    def bad_assigned_nodes(self) -> List[str]:
        return [n for n in self.assigned
                if self.topo.nodes[n].state in (NodeState.FAILED,
                                                NodeState.DEGRADED)]

    # -- rank binding (this job's fabric view) --------------------------- #
    def bind_rank(self, rank: int, node: str) -> None:
        old = self._rank_map.get(rank)
        if old is not None and self._node_rank.get(old) == rank:
            del self._node_rank[old]
        self._rank_map[rank] = node
        self._node_rank.setdefault(node, rank)

    def rebind_ranks(self, nodes_in_rank_order: List[str]) -> None:
        self._rank_map = dict(enumerate(nodes_in_rank_order))
        self._node_rank = {}
        for r, n in self._rank_map.items():
            self._node_rank.setdefault(n, r)

    def node_of_rank(self, rank: int) -> Optional[str]:
        return self._rank_map.get(rank)

    def rank_of_node(self, name: str) -> Optional[int]:
        return self._node_rank.get(name)

    def is_rank_down(self, rank: int) -> bool:
        name = self._rank_map.get(rank)
        if name is None:
            return True
        node = self.topo.nodes.get(name)
        return node is None or node.state in (NodeState.FAILED,
                                              NodeState.CORDONED)

    def fail_rank(self, rank: int, category: str = "node_hw") -> None:
        name = self._rank_map.get(rank)
        node = self.topo.nodes.get(name) if name is not None else None
        if node is not None and node.state in (NodeState.HEALTHY,
                                               NodeState.DEGRADED):
            node.state = NodeState.FAILED
            node.fail_category = category
            node.repair_at = self.clock.seconds + self.topo.repair_s

    def restore_rank(self, rank: int) -> None:
        name = self._rank_map.get(rank)
        node = self.topo.nodes.get(name) if name is not None else None
        if node is not None and node.state in (NodeState.FAILED,
                                               NodeState.DEGRADED):
            node.state = NodeState.HEALTHY
            node.fail_category = None

    # -- introspection ---------------------------------------------------- #
    def n_assigned(self) -> int:
        return len(self.assigned)

    def summary(self) -> Dict[str, int]:
        states: Dict[str, int] = {}
        for n in self.assigned:
            s = self.topo.nodes[n].state.value
            states[s] = states.get(s, 0) + 1
        return {"assigned": len(self.assigned), **states}

    def __repr__(self) -> str:
        return f"JobView({self.job_id!r}, {len(self.assigned)} nodes)"
