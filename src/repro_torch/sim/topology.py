"""One topology: nodes, links, spare pool, failure domains, rank binding.

This replaces the three private node/health models that used to live in
``tol/cluster.py`` (scheduler view), ``tce/transport.py`` (fabric ``_down``
set) and the scenario drivers: a single ``Topology`` instance is the shared
truth about which machine is healthy, which training rank it currently hosts,
and which failure domain (rack -> leaf switch) it sits in.

Failure domains make correlated faults first-class: ``fail_domain`` takes
out every member of a rack/switch at once, and the anti-affinity scheduler
can be asked to avoid a whole domain when placing replacements.

Storage is array-backed: node state, repair deadlines, fail categories,
leases and assignment live in flat numpy arrays indexed by slot, with a
name -> slot map, so ``free_nodes``, ``claimable_supply``, ``repair_due``
and the replacement scan are vector operations — O(10k) nodes cost
microseconds per query instead of a Python dict scan per event.
:class:`Node` is a *view* onto one slot: reading/writing ``node.state``,
``node.fail_category`` and ``node.repair_at`` goes straight to the arrays,
which keeps the historical per-node mutation API (tests and engines assign
``topo.nodes[n].state`` directly) working unchanged.
"""
from __future__ import annotations

import enum
import math
import threading
from typing import Dict, Iterable, List, NamedTuple, Optional, Set, Tuple

import numpy as np

from .clock import SimClock
from .faults import FaultEvent


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"     # straggler / flapping link
    FAILED = "failed"
    CORDONED = "cordoned"     # evicted, awaiting repair


# stable state <-> int8 code mapping for the flat arrays
_STATE_ORDER = (NodeState.HEALTHY, NodeState.DEGRADED, NodeState.FAILED,
                NodeState.CORDONED)
_CODE_OF = {s: np.int8(i) for i, s in enumerate(_STATE_ORDER)}
_H, _D, _F, _C = (np.int8(0), np.int8(1), np.int8(2), np.int8(3))


class Node:
    """One machine: a view onto its slot in the topology's flat arrays.

    ``name``/``rack``/``switch`` are immutable and stored on the view;
    ``state``/``fail_category``/``repair_at`` read and write the shared
    arrays, so mutating a ``Node`` and running a vectorized query are always
    consistent."""

    __slots__ = ("_topo", "_slot", "name", "rack", "switch")

    def __init__(self, topo: "Topology", slot: int):
        self._topo = topo
        self._slot = slot
        self.name = topo._names[slot]
        self.rack = topo._rack_names[topo._rack_id[slot]]
        self.switch = topo._switch_names[topo._switch_id[slot]]

    @property
    def state(self) -> NodeState:
        return _STATE_ORDER[self._topo._state[self._slot]]

    @state.setter
    def state(self, value: NodeState) -> None:
        topo = self._topo
        old = topo._state[self._slot]
        code = _CODE_OF[value]
        if old == code:
            return
        topo._state[self._slot] = code
        topo._claim_touch(self._slot)
        if topo._assigned_mask[self._slot]:
            nb = 1 if (code == _D or code == _F) else 0
            ob = 1 if (old == _D or old == _F) else 0
            topo._n_bad_assigned += nb - ob
        # leaving the repair-pending set (failed/cordoned) may raise the
        # true minimum above the cached scalar. Entering it keeps the cache
        # exact only because every engine writes ``repair_at`` right after
        # failing a node — the repair_at setter folds the new time in
        if code == _F or code == _C:
            topo._pending.add(self._slot)
        elif old == _F or old == _C:
            topo._pending.discard(self._slot)
            topo._min_exact = False

    @property
    def fail_category(self) -> Optional[str]:
        return self._topo._cat_names[self._topo._failcat[self._slot]]

    @fail_category.setter
    def fail_category(self, value: Optional[str]) -> None:
        self._topo._failcat[self._slot] = self._topo._cat_code(value)

    @property
    def repair_at(self) -> float:
        return float(self._topo._repair_at[self._slot])

    @repair_at.setter
    def repair_at(self, value: float) -> None:
        topo = self._topo
        old = float(topo._repair_at[self._slot])
        topo._repair_at[self._slot] = value
        if value < topo._min_repair_at:
            topo._min_repair_at = value
            s = topo._state[self._slot]
            if s != _F and s != _C:
                # min now tracks a non-pending node: keep it as a lower
                # bound (repair_due stays correct) but not as the exact min
                topo._min_exact = False
        elif old == topo._min_repair_at and value != old:
            topo._min_exact = False        # the min holder moved up

    def __repr__(self) -> str:
        return (f"Node(name={self.name!r}, state={self.state!r}, "
                f"rack={self.rack!r}, switch={self.switch!r})")


class DoubleGrantError(RuntimeError):
    """A node was granted to a second claimant while still leased.

    The claim ledger makes this impossible through the public API; raising
    (rather than silently reassigning) turns any future regression in the
    arbitration path into a loud failure instead of two jobs sharing a
    machine."""


class NodeLease(NamedTuple):
    """Ownership record: which claimant (job) holds which machine.

    A ``NamedTuple`` rather than a dataclass: leases are minted on every
    replacement grant in the hot recovery path, and tuple construction is
    ~3x cheaper than a frozen dataclass ``__init__``."""
    node: str
    claimant: str
    granted_at: float


def nodes_for_fault_rate(faults_per_week: float,
                         mtbf_node_days: float) -> int:
    """MTBF-scaled node count: the fleet size at which independent per-node
    failures (MTBF ``mtbf_node_days``) aggregate to the target cluster-wide
    fault rate.

    Anchors: BLOOM saw 1-2 GPU failures/week on ~48 nodes (MTBF ~170-340 d);
    OPT-175B logged 40+ interruptions in 2 weeks on 124 nodes. The policy
    sweep uses this to turn a ``fault_rate`` axis into a concrete cluster.
    """
    if faults_per_week <= 0 or mtbf_node_days <= 0:
        raise ValueError("faults_per_week and mtbf_node_days must be > 0")
    return max(1, round(faults_per_week * mtbf_node_days / 7.0))


class _AssignedList(list):
    """``Topology.assigned`` with a boolean-mask shadow in the flat arrays.

    The single-job facade (and some tests) mutate ``assigned`` as a plain
    list; this subclass keeps ``topo._assigned_mask`` in sync so the
    vectorized queries (``free_nodes``, ``claimable_supply``,
    ``bad_assigned_nodes``) never scan the list."""

    __slots__ = ("_topo", "_slot_buf", "_pos_of_slot", "_n_slots")

    def __init__(self, topo: "Topology", iterable: Iterable[str] = ()):
        super().__init__(iterable)
        self._topo = topo
        # capacity-backed slot-id mirror of the list plus its inverse
        # (slot -> list position): remove() finds its position in O(1)
        # instead of scanning the name list
        self._slot_buf = np.empty(max(len(topo._names), len(self), 1),
                                  np.int64)
        self._pos_of_slot = np.full(max(len(topo._names), 1), -1, np.int64)
        self._n_slots = 0
        self._rebuild()

    def _rebuild(self) -> None:
        topo = self._topo
        n = len(self)
        if n > self._slot_buf.size:
            self._slot_buf = np.empty(n, np.int64)
        for k, name in enumerate(self):
            self._slot_buf[k] = topo._idx[name]
        self._n_slots = n
        self._pos_of_slot[:] = -1
        self._pos_of_slot[self._slot_buf[:n]] = np.arange(n)
        topo._assigned_mask[:] = False
        topo._assigned_mask[self._slot_buf[:n]] = True
        topo._claim_ok = None
        s = topo._state
        topo._n_bad_assigned = int(np.count_nonzero(
            ((s == _D) | (s == _F)) & topo._assigned_mask))

    def append(self, name: str) -> None:
        super().append(name)
        topo = self._topo
        i = topo._idx[name]
        if self._n_slots == self._slot_buf.size:
            self._slot_buf = np.concatenate(
                [self._slot_buf, np.empty(self._slot_buf.size, np.int64)])
        self._slot_buf[self._n_slots] = i
        self._pos_of_slot[i] = self._n_slots
        self._n_slots += 1
        topo._assigned_mask[i] = True
        s = topo._state[i]
        if s == _D or s == _F:
            topo._n_bad_assigned += 1
        topo._claim_touch(i)

    def remove(self, name: str) -> None:
        topo = self._topo
        i = topo._idx[name]
        n = self._n_slots
        k = int(self._pos_of_slot[i])
        if k < 0 or k >= n or self._slot_buf[k] != i:
            raise ValueError(f"{name!r} not in assigned list")
        super().__delitem__(k)
        self._slot_buf[k:n - 1] = self._slot_buf[k + 1:n]
        self._pos_of_slot[self._slot_buf[k:n - 1]] -= 1
        self._pos_of_slot[i] = -1
        self._n_slots = n - 1
        topo._assigned_mask[i] = False
        s = topo._state[i]
        if s == _D or s == _F:
            topo._n_bad_assigned -= 1
        topo._claim_touch(i)

    # rarely-used list mutators fall back to a full mask rebuild
    def extend(self, iterable) -> None:
        super().extend(iterable)
        self._rebuild()

    def insert(self, index, name) -> None:
        super().insert(index, name)
        self._rebuild()

    def pop(self, index=-1):
        out = super().pop(index)
        self._rebuild()
        return out

    def clear(self) -> None:
        super().clear()
        self._rebuild()

    def __setitem__(self, key, value) -> None:
        super().__setitem__(key, value)
        self._rebuild()

    def __delitem__(self, key) -> None:
        super().__delitem__(key)
        self._rebuild()

    def __contains__(self, name) -> bool:
        i = self._topo._idx.get(name)
        return bool(self._topo._assigned_mask[i]) if i is not None else False

    def slots(self) -> np.ndarray:
        return self._slot_buf[:self._n_slots].copy()


class Topology:
    """Nodes + spares + failure domains + the rank->node binding.

    The constructor signature is kept compatible with the old ``ClusterSim``
    (``tol.cluster.ClusterSim`` is now an alias of this class); the domain
    and rank-binding layers are additive.
    """

    DEFAULT_CLAIMANT = "job0"

    def __init__(self, n_nodes: int, n_spares: int = 4,
                 repair_hours: float = 24.0, nodes_per_rack: int = 8,
                 racks_per_switch: int = 4, clock: Optional[SimClock] = None,
                 auto_assign: bool = True):
        self.clock = clock or SimClock()
        self.nodes_per_rack = max(nodes_per_rack, 1)
        self.racks_per_switch = max(racks_per_switch, 1)
        cap = n_nodes + n_spares
        # flat per-slot arrays: active nodes at slots [0, n_nodes), spares
        # after them so a replacement naturally lands outside a failed domain
        self._names: List[str] = (
            [f"node{i:04d}" for i in range(n_nodes)]
            + [f"spare{i:04d}" for i in range(n_spares)])
        self._idx: Dict[str, int] = {n: i for i, n in enumerate(self._names)}
        self._state = np.zeros(cap, np.int8)
        self._repair_at = np.zeros(cap, np.float64)
        # scalar lower bound on the earliest pending repair: lets the hot
        # per-event repair_due call return without touching the arrays.
        # _min_exact means the bound is the *exact* minimum (inf = none
        # pending), making next_repair_at O(1) between invalidations
        self._min_repair_at = math.inf
        self._min_exact = True
        # slots currently failed|cordoned (any membership): the repair sweep
        # and next_repair_at walk this small set instead of scanning arrays
        self._pending: Set[int] = set()
        # exact |{assigned & (degraded|failed)}|: lets bad_assigned_nodes
        # answer the overwhelmingly common "none" in O(1)
        self._n_bad_assigned = 0
        # dirty-cached claimable mask (healthy & unleased & unassigned) and
        # its popcount, shared by claimable_supply and the claim fast path.
        # Single-slot writes land in _claim_dirty and are patched in on the
        # next read; bulk rewrites reset _claim_ok to None instead
        self._claim_ok: Optional[np.ndarray] = None
        self._n_claimable = 0
        self._claim_dirty: Set[int] = set()
        # persistent uint8 view of the state codes for branch-free masks
        self._state_u8 = self._state.view(np.uint8)
        self._u8_scratch = np.empty(cap, np.uint8)
        self._failcat = np.zeros(cap, np.int32)
        self._leased_mask = np.zeros(cap, bool)
        self._assigned_mask = np.zeros(cap, bool)
        self._member_mask = np.zeros(cap, bool)   # slot present in .nodes
        self._cat_names: List[Optional[str]] = [None]
        self._cat_codes: Dict[Optional[str], int] = {None: 0}
        self._rack_id = np.arange(cap, dtype=np.int64) // self.nodes_per_rack
        self._switch_id = self._rack_id // self.racks_per_switch
        self._rack_names = [f"rack{r:02d}"
                            for r in range(int(self._rack_id[-1]) + 1 if cap
                                           else 0)]
        self._switch_names = [f"switch{s:02d}"
                              for s in range(int(self._switch_id[-1]) + 1
                                             if cap else 0)]
        self._rack_code = {n: i for i, n in enumerate(self._rack_names)}
        self._switch_code = {n: i for i, n in enumerate(self._switch_names)}

        views = [Node(self, i) for i in range(cap)]
        self.nodes: Dict[str, Node] = {v.name: v for v in views[:n_nodes]}
        self._member_mask[:n_nodes] = True
        self.spares: List[Node] = list(views[n_nodes:])
        # replacement scan order: .nodes insertion order (spares appended as
        # they move in); cached as an array for the vectorized claim scan
        self._scan_slots: List[int] = list(range(n_nodes))
        self._scan_cache: Optional[np.ndarray] = None
        # slot -> position in scan order, for the constraint-free claim
        # fast path (rebuilt lazily whenever _scan_slots changes)
        self._scan_rank: Optional[np.ndarray] = None
        # (kind, domain) -> member names, precomputed once over all slots
        # (slot order == the old nodes-then-spares pool order)
        self._domain_members: Dict[Tuple[str, str], List[str]] = {}
        for v in views:
            self._domain_members.setdefault(("rack", v.rack), []).append(
                v.name)
            self._domain_members.setdefault(("switch", v.switch), []).append(
                v.name)
        self.repair_s = repair_hours * 3600.0
        # claim ledger: node -> lease. Every node a job runs on is leased;
        # the single-job facade below leases to DEFAULT_CLAIMANT, the fleet
        # scheduler leases per job. A node can hold at most one lease —
        # granting a leased node raises DoubleGrantError.
        self._leases: Dict[str, NodeLease] = {}
        # single-job facade: `assigned` is DEFAULT_CLAIMANT's node list (the
        # historical ClusterSim interface). Multi-job callers pass
        # auto_assign=False and allocate through the claim API instead.
        self.assigned: _AssignedList = _AssignedList(
            self, list(self.nodes) if auto_assign else ())
        self._rank_map: Dict[int, str] = dict(enumerate(self.assigned))
        self._node_rank: Dict[str, int] = {
            n: r for r, n in self._rank_map.items()}
        self._lock = threading.Lock()
        for n in self.assigned:
            self._leases[n] = NodeLease(n, self.DEFAULT_CLAIMANT, 0.0)
            self._leased_mask[self._idx[n]] = True

    # -- construction --------------------------------------------------- #
    def _cat_code(self, category: Optional[str]) -> int:
        code = self._cat_codes.get(category)
        if code is None:
            code = len(self._cat_names)
            self._cat_names.append(category)
            self._cat_codes[category] = code
        return code

    # -- failure domains ------------------------------------------------ #
    def domain_members(self, kind: str, name: str) -> List[str]:
        """All known nodes (incl. spares) in rack/switch ``name``."""
        assert kind in ("rack", "switch"), kind
        return list(self._domain_members.get((kind, name), ()))

    def domain_of(self, node: str, kind: str = "rack") -> str:
        return getattr(self.nodes[node], kind)

    def fail_domain(self, kind: str, name: str, t: float = 0.0,
                    category: str = "network") -> List[str]:
        """Correlated failure: every assigned member of the domain goes down."""
        hit = []
        cat = self._cat_code(category)
        for n in self.domain_members(kind, name):
            i = self._idx[n]
            if self._member_mask[i] and self._state[i] in (_H, _D):
                if self._assigned_mask[i] and self._state[i] == _H:
                    self._n_bad_assigned += 1
                self._state[i] = _F
                self._pending.add(i)
                self._failcat[i] = cat
                self._repair_at[i] = t + self.repair_s
                self._min_repair_at = min(self._min_repair_at,
                                          t + self.repair_s)
                hit.append(n)
        if hit:
            self._claim_ok = None
        return hit

    # -- fault application ---------------------------------------------- #
    def apply_fault(self, ev: FaultEvent) -> None:
        i = self._idx.get(ev.node)
        if i is None or not self._member_mask[i] or self._state[i] != _H:
            return
        self._state[i] = _D if ev.degrades_only else _F
        if self._assigned_mask[i]:
            self._n_bad_assigned += 1     # guard above: old state was healthy
        self._failcat[i] = self._cat_code(ev.category)
        self._repair_at[i] = ev.t + self.repair_s
        self._min_repair_at = min(self._min_repair_at, ev.t + self.repair_s)
        self._claim_touch(i)
        if ev.degrades_only:
            # a degraded node is not repair-pending, so the lowered bound
            # may undershoot the exact pending minimum
            self._min_exact = False
        else:
            self._pending.add(i)

    def repair_due(self, t: float) -> None:
        if t < self._min_repair_at:        # nothing due yet: O(1) fast path
            return
        # walk the (small) failed|cordoned slot set instead of scanning the
        # state array: O(pending), and per-event pending is a handful
        st, ra, mm = self._state, self._repair_at, self._member_mask
        am = self._assigned_mask
        healed: List[int] = []
        mr = math.inf
        for i in self._pending:
            if not mm[i]:
                continue
            r = ra[i]
            if r <= t:
                healed.append(i)
            elif r < mr:
                mr = float(r)
        for i in healed:
            if am[i] and st[i] == _F:      # cordoned was already not-bad
                self._n_bad_assigned -= 1
            st[i] = _H
            self._failcat[i] = 0
            self._pending.discard(i)
            self._claim_touch(i)
        # retighten the bound to the repairs still pending (inf when none)
        self._min_repair_at = mr
        self._min_exact = True

    def next_repair_at(self) -> Optional[float]:
        """Earliest ``repair_at`` among failed/cordoned members (the wait
        target the engines used to find with an O(n) scan per recovery)."""
        if self._min_exact:                # O(1): the cached bound is exact
            return (None if self._min_repair_at == math.inf
                    else self._min_repair_at)
        ra, mm = self._repair_at, self._member_mask
        mr = math.inf
        for i in self._pending:
            if mm[i]:
                r = ra[i]
                if r < mr:
                    mr = float(r)
        self._min_repair_at = mr
        self._min_exact = True
        return None if mr == math.inf else mr

    # -- claim ledger (shared spare-pool arbitration) -------------------- #
    def _grant(self, name: str, claimant: str) -> None:
        """Record a lease; the one place ownership is written. Raises
        :class:`DoubleGrantError` if the node is already leased — two
        concurrent claimants can never be handed the same machine."""
        if name in self._leases:
            raise DoubleGrantError(
                f"{name} already leased to {self._leases[name].claimant!r}, "
                f"refused grant to {claimant!r}")
        self._leases[name] = NodeLease(name, claimant, self.clock.seconds)
        i = self._idx[name]
        self._leased_mask[i] = True
        self._claim_touch(i)

    def owner_of(self, name: str) -> Optional[str]:
        lease = self._leases.get(name)
        return lease.claimant if lease is not None else None

    def leases_of(self, claimant: str) -> List[str]:
        return sorted(n for n, l in self._leases.items()
                      if l.claimant == claimant)

    def n_leased(self) -> int:
        return len(self._leases)

    def release_node(self, name: str, claimant: Optional[str] = None) -> None:
        """Drop a lease (eviction, job completion, preemption donation).
        When ``claimant`` is given it must match the lease holder."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                return
            if claimant is not None and lease.claimant != claimant:
                raise DoubleGrantError(
                    f"{claimant!r} tried to release {name} "
                    f"leased to {lease.claimant!r}")
            del self._leases[name]
            i = self._idx[name]
            self._leased_mask[i] = False
            self._claim_touch(i)

    def _free_mask(self) -> np.ndarray:
        """Healthy, unleased, unassigned active members (vector form)."""
        return ((self._state == _H) & self._member_mask
                & ~self._leased_mask & ~self._assigned_mask)

    def free_nodes(self) -> List[str]:
        """Healthy, unleased active nodes (spares not included: they stay in
        the replacement pool until claimed)."""
        names = self._names
        return sorted(names[i] for i in np.flatnonzero(self._free_mask()))

    def _claimable(self) -> np.ndarray:
        """Dirty-cached claimable mask (healthy & unleased & unassigned:
        free members plus the not-yet-claimed spare pool, since claimed
        spares are members) and its popcount in ``_n_claimable``. Callers
        must treat the returned array as read-only."""
        ok = self._claim_ok
        if ok is None or len(self._claim_dirty) > 16:
            # healthy & ~leased & ~assigned as bool>bool in-place: three
            # ufunc dispatches, no intermediate inverted masks
            ok = self._state == _H
            np.greater(ok, self._leased_mask, out=ok)
            np.greater(ok, self._assigned_mask, out=ok)
            self._claim_ok = ok
            self._n_claimable = int(np.count_nonzero(ok))
            self._claim_dirty.clear()
        elif self._claim_dirty:
            # patch the few touched slots in place: O(dirty), not O(cap)
            st, lm, am = self._state, self._leased_mask, self._assigned_mask
            n = self._n_claimable
            for i in self._claim_dirty:
                new = bool(st[i] == _H) and not lm[i] and not am[i]
                if new != bool(ok[i]):
                    ok[i] = new
                    n += 1 if new else -1
            self._n_claimable = n
            self._claim_dirty.clear()
        return ok

    def _claim_touch(self, i: int) -> None:
        """Mark one slot's claimability as possibly changed."""
        if self._claim_ok is not None:
            self._claim_dirty.add(i)

    def claimable_supply(self, anti_affinity: Iterable[str] = ()) -> int:
        """How many machines :meth:`claim_replacement` could grant right now
        (healthy spares plus healthy unleased nodes outside the anti-affinity
        set). Read-only: the RecoveryPlanner's supply snapshot."""
        ok = self._claimable()
        n = self._n_claimable
        for name in set(anti_affinity):
            i = self._idx.get(name)
            if i is not None and ok[i]:
                n -= 1
        return n

    def claim_specific(self, name: str, claimant: str) -> str:
        """Gang scheduling: claim one named free healthy node atomically."""
        with self._lock:
            node = self.nodes.get(name)
            if node is None:
                raise KeyError(f"unknown node {name!r}")
            if node.state != NodeState.HEALTHY:
                raise ValueError(f"{name} is {node.state.value}, not claimable")
            self._grant(name, claimant)
        return name

    def reassign_lease(self, name: str, new_claimant: str) -> None:
        """Atomically move a leased node between claimants (preemption: a
        low-priority job donates a machine to a high-priority recovery).
        The node is never observable as unleased in between."""
        with self._lock:
            lease = self._leases.get(name)
            if lease is None:
                raise KeyError(f"{name} has no lease to reassign")
            self._leases[name] = NodeLease(name, new_claimant,
                                           self.clock.seconds)

    def claim_replacement(self, claimant: str, anti_affinity: Set[str],
                          avoid_domains: Iterable[str] = ()
                          ) -> Optional[str]:
        """Arbitrated replacement pick: a healthy unleased node not in the
        anti-affinity set (fresh spare first, then repaired nodes),
        preferring nodes outside the given rack/switch failure domains.
        The winner is leased to ``claimant`` before the call returns, so
        interleaved claimants can never be granted the same machine.

        Domain avoidance is a soft preference: when every candidate sits in
        an avoided domain (small clusters where one rack holds everything),
        an in-domain node is still returned rather than failing the job.
        The anti-affinity set stays a hard exclusion — those nodes are known
        bad."""
        avoid = set(avoid_domains)
        with self._lock:
            if not self.spares and not anti_affinity and not avoid:
                # constraint-free claim (the per-fault common case): pick
                # the first healthy unleased unassigned slot in scan order
                # straight off the cached claimable mask
                ok = self._claimable()
                if not self._n_claimable:
                    return None
                if self._scan_rank is None:
                    r = np.full(len(self._names), len(self._names),
                                np.int64)
                    r[np.asarray(self._scan_slots, dtype=np.int64)] = \
                        np.arange(len(self._scan_slots))
                    self._scan_rank = r
                # claimable is a handful of slots: one bool scan for the
                # hits, then a tiny Python min by scan rank (beats a full
                # int64 where+argmin over every slot)
                hits = np.flatnonzero(ok)
                rank = self._scan_rank
                slot = int(min(hits.tolist(), key=rank.__getitem__))
                if rank[slot] >= len(self._names):
                    return None          # only out-of-scan slots were free
                name = self._names[slot]
                self._grant(name, claimant)
                return name
            # move the whole spare pool into the node set, then scan in
            # preference order: fresh spares first, then the pre-existing
            # scan order (actives, then previously-moved spares)
            fresh_slots: List[int] = []
            while self.spares:
                sp = self.spares.pop(0)
                self.nodes[sp.name] = sp
                self._member_mask[sp._slot] = True
                fresh_slots.append(sp._slot)
            if fresh_slots:
                prior = self._scan_slots
                cand = np.array(fresh_slots + prior, dtype=np.int64)
                self._scan_slots = prior + fresh_slots
                self._scan_cache = None
                self._scan_rank = None
            else:
                if self._scan_cache is None or \
                        len(self._scan_cache) != len(self._scan_slots):
                    self._scan_cache = np.asarray(self._scan_slots,
                                                  dtype=np.int64)
                cand = self._scan_cache
            if cand.size == 0:
                return None
            ok = ((self._state[cand] == _H) & ~self._leased_mask[cand]
                  & ~self._assigned_mask[cand])
            for n in anti_affinity:
                i = self._idx.get(n)
                if i is not None:
                    ok &= cand != i
            dom_bad = np.zeros(cand.size, bool)
            for d in avoid:
                rid = self._rack_code.get(d)
                if rid is not None:
                    dom_bad |= self._rack_id[cand] == rid
                sid = self._switch_code.get(d)
                if sid is not None:
                    dom_bad |= self._switch_id[cand] == sid
            for require_domain in (True, False):
                m = ok & ~dom_bad if require_domain else ok
                hit = np.flatnonzero(m)
                if hit.size:
                    name = self._names[int(cand[hit[0]])]
                    self._grant(name, claimant)
                    return name
            return None

    # -- scheduling ------------------------------------------------------ #
    def _cordon_slot(self, i: int, t: float) -> None:
        """Cordon one member slot (shared by :meth:`cordon` / :meth:`evict`)."""
        r = t + self.repair_s
        old = float(self._repair_at[i])
        so = self._state[i]
        was_pending = so == _F or so == _C
        if self._assigned_mask[i] and (so == _D or so == _F):
            self._n_bad_assigned -= 1      # cordoned is not degraded|failed
        self._state[i] = _C
        self._pending.add(i)
        self._repair_at[i] = r
        self._claim_touch(i)
        if r < self._min_repair_at:
            self._min_repair_at = r
        elif was_pending and old == self._min_repair_at and r != old:
            self._min_exact = False        # the min holder moved up

    def cordon(self, name: str, t: float) -> None:
        """Mark a bad node cordoned and queue it for repair (state change
        only; lease/assignment bookkeeping is the caller's)."""
        i = self._idx.get(name)
        if i is not None and self._member_mask[i]:
            self._cordon_slot(i, t)

    def evict(self, name: str, t: float) -> None:
        """Cordon a bad node, release its lease and return it to the repair
        queue (one slot lookup for the whole cordon+release+unassign chain)."""
        i = self._idx.get(name)
        if i is None:
            return
        if self._member_mask[i]:
            self._cordon_slot(i, t)
        with self._lock:
            if self._leases.pop(name, None) is not None:
                self._leased_mask[i] = False
                self._claim_touch(i)
        if self._assigned_mask[i]:
            self.assigned.remove(name)

    def schedule_replacement(self, anti_affinity: Set[str],
                             avoid_domains: Iterable[str] = (),
                             claimant: Optional[str] = None
                             ) -> Optional[str]:
        """Single-job facade over :meth:`claim_replacement`: the granted node
        joins ``assigned`` (the historical ClusterSim behaviour)."""
        name = self.claim_replacement(claimant or self.DEFAULT_CLAIMANT,
                                      anti_affinity, avoid_domains)
        if name is not None:
            self.assigned.append(name)
        return name

    def bad_assigned_nodes(self) -> List[str]:
        # counter fast path: the overwhelmingly common answer is "none",
        # and the exact |assigned & (degraded|failed)| count is maintained
        # at every state/membership write site
        if not self._n_bad_assigned:
            return []
        # degraded|failed is codes {1, 2}, i.e. (state - 1) <= 1 in uint8
        # arithmetic (healthy wraps to 255, cordoned lands on 2)
        np.subtract(self._state_u8, np.uint8(1), out=self._u8_scratch)
        bad = self._u8_scratch <= np.uint8(1)
        bad &= self._assigned_mask
        idx = self._idx
        return [n for n in self.assigned if bad[idx[n]]]

    def is_assigned(self, name: str) -> bool:
        """O(1) membership test against ``assigned`` (mask-backed)."""
        i = self._idx.get(name)
        return bool(self._assigned_mask[i]) if i is not None else False

    # -- rank binding (the fabric's up/down view) ------------------------ #
    def bind_rank(self, rank: int, node: str) -> None:
        with self._lock:
            old = self._rank_map.get(rank)
            if old is not None and self._node_rank.get(old) == rank:
                del self._node_rank[old]
            self._rank_map[rank] = node
            self._node_rank.setdefault(node, rank)

    def rebind_ranks(self, nodes_in_rank_order: List[str]) -> None:
        """Reset the whole binding (elastic shrink/grow re-ranks survivors)."""
        with self._lock:
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
        i = self._idx.get(name)
        return (i is None or not self._member_mask[i]
                or self._state[i] in (_F, _C))

    def fail_rank(self, rank: int, category: str = "node_hw") -> None:
        name = self._rank_map.get(rank)
        node = self.nodes.get(name) if name is not None else None
        if node is not None and node.state in (NodeState.HEALTHY,
                                               NodeState.DEGRADED):
            node.state = NodeState.FAILED
            node.fail_category = category
            node.repair_at = self.clock.seconds + self.repair_s

    def restore_rank(self, rank: int) -> None:
        name = self._rank_map.get(rank)
        node = self.nodes.get(name) if name is not None else None
        if node is not None and node.state in (NodeState.FAILED,
                                               NodeState.DEGRADED):
            node.state = NodeState.HEALTHY
            node.fail_category = None

    # -- introspection ---------------------------------------------------- #
    def n_assigned(self) -> int:
        return len(self.assigned)

    def summary(self) -> Dict[str, int]:
        codes = self._state[self._member_mask]
        counts = np.bincount(codes, minlength=len(_STATE_ORDER))
        out: Dict[str, int] = {"assigned": len(self.assigned),
                               "spares": len(self.spares),
                               "leased": len(self._leases)}
        for s, c in zip(_STATE_ORDER, counts):
            if c:
                out[s.value] = int(c)
        return out
