"""Unified fault model: the Table-I taxonomy + injectors.

This is the single source of truth for fault categories. TEE's trace
generator maps each category to the metric signature the detector sees,
TOL's cluster simulation samples schedules from the same category mix, and
TCE observes the resulting node failures through the shared topology — so
the detector is exercised on exactly the faults the cluster experiences.

Beyond the paper's independent per-node failures, the injector supports
*correlated* faults (a switch/rack failure domain taking out every member
node at once) and *cascading* faults (a follow-on failure sampled inside the
recovery window of a primary fault — the case that forces TCE down the
waterfall from ring backup to persistent store).

Sampling is vectorized: ``FaultInjector.schedule`` draws every inter-arrival
time, category and straggler flag in batched numpy passes from per-node
counter-based streams (splitmix64 over a packed ``(node, channel, k)``
counter), so the schedule for node ``i`` is independent of ``n_nodes`` and
of how the batch was chunked. The seed repo's per-node Python loop is kept
as :meth:`FaultInjector.schedule_legacy` — it is the baseline the simulator
benchmark measures its speedup against.

``FailureMix`` packages an empirical failure-mix distribution (category
weights + rate/cascade calibration) so the trace-replay presets can swap
the Table-I mix for e.g. a ByteDance-style infra-dominated mix.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Any, Dict, Iterable, List, Mapping,
                    Optional, Sequence, Tuple)

import numpy as np

if TYPE_CHECKING:                       # no import cycle: clock <- faults
    from .clock import EventQueue

# Table I categories with observed task counts (May–Jul 2023, SenseCore)
FAULT_CATEGORIES: Dict[str, int] = {
    "storage": 34,
    "network": 43,
    "node_hw": 66,
    "user_code": 179,
    "other": 55,
}

# fault category -> metric signature TEE's trace generator applies during the
# anomaly window ("straggler" is a degradation mode, not a Table-I category)
SIGNATURES: Dict[str, str] = {
    "storage": "io_stall",
    "network": "comm_drop",
    "node_hw": "crash",
    "user_code": "log_burst_exit",
    "other": "freeze",
    "straggler": "straggler",      # slow rank -> cluster-wide tail latency
}


@dataclass(frozen=True, slots=True)
class FaultEvent:
    """One injected fault on the shared timeline.

    ``domain`` tags correlated events ("rack00", "switch01", ...) so that a
    group of simultaneous node failures is attributable to one root cause;
    ``cascade_of`` points at the primary event a cascading fault followed.
    """
    t: float
    node: str
    category: str
    degrades_only: bool           # straggler/flap vs hard failure
    domain: Optional[str] = None
    cascade_of: Optional[str] = None


def category_weights(cats: Optional[Sequence[str]] = None,
                     weights: Optional[Mapping[str, float]] = None
                     ) -> np.ndarray:
    """Normalized category probabilities; ``weights`` overrides the Table-I
    counts (a :class:`FailureMix`'s relative weights)."""
    table = weights if weights is not None else FAULT_CATEGORIES
    cats = list(cats if cats is not None else table)
    w = np.array([table[c] for c in cats], np.float64)
    return w / w.sum()


# --------------------------------------------------------------------------- #
# empirical failure mixes (trace replay)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class FailureMix:
    """One empirical failure-mix distribution: category weights plus the
    rate/correlation calibration the replay presets feed the injectors."""
    name: str
    source: str
    weights: Mapping[str, float]       # category -> relative weight
    mtbf_node_days: float              # per-node MTBF the mix was observed at
    straggler_frac: float              # degradation (slow-rank) share
    p_cascade: float                   # follow-on failure probability
    rack_mtbf_days: float              # per-rack correlated-outage MTBF


MIXES: Dict[str, FailureMix] = {
    # the paper's Table I (May–Jul 2023, SenseCore): user-code dominated,
    # node MTBF anchored at the Fig. 6 cluster's 110 days
    "table1": FailureMix(
        name="table1", source="TRANSOM Table I",
        weights=dict(FAULT_CATEGORIES),
        mtbf_node_days=110.0, straggler_frac=0.15, p_cascade=0.1,
        rack_mtbf_days=365.0),
    # ByteDance-style datacenter mix (modelled after "Robust LLM Training
    # Infrastructure at ByteDance", PAPERS.md): infra faults dominate —
    # GPU/HBM hardware and fabric incidents over user code — with more
    # stragglers and denser correlated switch outages at 10k+ scale. The
    # weights are a modelled calibration, not published counts.
    "bytedance": FailureMix(
        name="bytedance", source="ByteDance-style (modelled, PAPERS.md)",
        weights={"storage": 10, "network": 30, "node_hw": 40,
                 "user_code": 10, "other": 10},
        mtbf_node_days=60.0, straggler_frac=0.25, p_cascade=0.15,
        rack_mtbf_days=120.0),
}


def get_mix(name: str) -> FailureMix:
    try:
        return MIXES[name]
    except KeyError:
        raise KeyError(f"unknown failure mix {name!r}; "
                       f"have {sorted(MIXES)}") from None


# --------------------------------------------------------------------------- #
# counter-based per-node uniform streams (splitmix64)
# --------------------------------------------------------------------------- #
# Each draw is indexed by a packed (node, channel, k) counter; uniforms are a
# pure function of (seed, counter), so node i's stream never depends on
# n_nodes, on the other nodes, or on how the batch was chunked.
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_NODE_SHIFT = np.uint64(34)            # node id in the top 30 bits
_CH_SHIFT = np.uint64(31)              # 3-bit channel
_CH_ARRIVAL, _CH_CATEGORY, _CH_STRAGGLER = (np.uint64(0), np.uint64(1),
                                            np.uint64(2))
_U53 = np.uint64(11)
_INV53 = float(2.0 ** -53)


def _mix64(z: np.ndarray) -> np.ndarray:
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def _stream_key(seed: int) -> np.uint64:
    return _mix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * _GAMMA
                  + np.uint64(0xD1B54A32D192ED03))


def counter_uniforms(seed: int, node: np.ndarray, channel: np.uint64,
                     k: np.ndarray) -> np.ndarray:
    """float64 uniforms in [0, 1), a pure function of (seed, node, channel,
    k) — the vectorized replacement for per-node ``Generator`` streams."""
    with np.errstate(over="ignore"):
        idx = ((node.astype(np.uint64) << _NODE_SHIFT)
               | (channel << _CH_SHIFT) | k.astype(np.uint64))
        z = _mix64(_stream_key(seed) + (idx + np.uint64(1)) * _GAMMA)
    return (z >> _U53) * _INV53


class FaultInjector:
    """Samples a fault schedule with the Table I category mix.

    Rate calibration: BLOOM saw 1-2 GPU failures/week on ~48 nodes; OPT-175B
    logged 40+ interruptions in 2 weeks on 124 nodes. Default: each node
    fails independently, MTBF_node ~ exp(mean_days).

    ``weights`` swaps the Table-I category mix for another empirical
    distribution (see :data:`MIXES`).
    """

    def __init__(self, n_nodes: int, mean_days_between_node_faults: float = 30.0,
                 horizon_days: float = 120.0, straggler_frac: float = 0.15,
                 seed: int = 0, weights: Optional[Mapping[str, float]] = None):
        self.n_nodes = n_nodes
        self.mtbf = mean_days_between_node_faults
        self.horizon = horizon_days
        self.straggler_frac = straggler_frac
        self.seed = seed
        self.cats = list(weights if weights is not None else FAULT_CATEGORIES)
        self.w = category_weights(self.cats, weights)
        self._cumw = np.cumsum(self.w)
        self._cumw[-1] = 1.0
        # test hook: force the sampling chunk width (None = auto-sized).
        # The schedule is a pure function of the counter streams, so any
        # width yields the same events — tests assert exactly that
        self._chunk_width: Optional[int] = None
        # name table built once: schedule() may be called per replay step
        self._node_names = [f"node{i:04d}" for i in range(n_nodes)]

    def schedule(self) -> List[FaultEvent]:
        """Vectorized sampler: all inter-arrival times, categories and
        straggler flags are drawn in batched numpy passes from per-node
        counter streams. Deterministic in (seed, mtbf, horizon, mix) and
        a prefix-stable function of ``n_nodes``: growing the cluster never
        changes the schedule of the existing nodes."""
        n = self.n_nodes
        if n <= 0 or self.horizon <= 0 or self.mtbf <= 0:
            return []
        lam = self.horizon / self.mtbf            # expected events per node
        # chunk width only sets how many columns are drawn per pass — the
        # schedule itself is chunk-invariant (counter streams are pure
        # functions of (node, ordinal)), so size it to the Poisson tail
        # rather than over-drawing: mean + ~6 sigma, floor 4
        width = self._chunk_width or max(4, int(lam + 6.0 * math.sqrt(lam))
                                         + 2)
        alive = np.arange(n, dtype=np.int64)      # nodes still below horizon
        t_acc = np.zeros(n)
        counts = np.zeros(n, np.int64)            # per-node event ordinals
        chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        k0 = 0
        while alive.size:
            cols = np.arange(k0, k0 + width, dtype=np.uint64)
            u = counter_uniforms(self.seed, alive[:, None], _CH_ARRIVAL,
                                 np.broadcast_to(cols, (alive.size, width)))
            gaps = -self.mtbf * np.log1p(-u)
            # fold the carry into the cumsum so the partial sums are exactly
            # the sequential ((t_acc + g0) + g1) + ... — adding t_acc after a
            # standalone cumsum associates differently and lets the chunk
            # width leak 1-ULP drift into event times across chunk boundaries
            cum = np.cumsum(
                np.concatenate([t_acc[alive, None], gaps], axis=1),
                axis=1)[:, 1:]
            valid = cum < self.horizon            # prefix mask per row
            nv = valid.sum(axis=1)
            if nv.any():
                ords = (counts[alive][:, None]
                        + np.arange(width, dtype=np.int64)[None, :])
                chunks.append((np.repeat(alive, nv), cum[valid], ords[valid]))
                counts[alive] += nv
            t_acc[alive] = cum[:, -1]
            alive = alive[nv == width]            # full row => maybe more due
            k0 += width
        if not chunks:
            return []
        node = np.concatenate([c[0] for c in chunks])
        t_days = np.concatenate([c[1] for c in chunks])
        ordv = np.concatenate([c[2] for c in chunks])
        cat_u = counter_uniforms(self.seed, node, _CH_CATEGORY, ordv)
        cat_ix = np.searchsorted(self._cumw, cat_u, side="right")
        cat_ix = np.minimum(cat_ix, len(self.cats) - 1)
        strag = counter_uniforms(self.seed, node, _CH_STRAGGLER, ordv) \
            < self.straggler_frac
        order = np.argsort(t_days, kind="stable")
        names = self._node_names
        cats = self.cats
        return [FaultEvent(float(t_days[j]) * 86400.0, names[node[j]],
                           cats[cat_ix[j]], bool(strag[j]))
                for j in order]

    def schedule_legacy(self) -> List[FaultEvent]:
        """The seed repo's per-node Python-loop sampler, kept verbatim as the
        benchmark baseline (``benchmarks/sim_bench.py`` measures the
        vectorized sampler's speedup against this hot loop). Draws a
        *different* stream than :meth:`schedule`."""
        rng = np.random.default_rng(self.seed)
        cats, w = self.cats, self.w
        out: List[FaultEvent] = []
        for i in range(self.n_nodes):
            t = 0.0
            while True:
                t += float(rng.exponential(self.mtbf))
                if t >= self.horizon:
                    break
                cat = str(rng.choice(cats, p=w))
                out.append(FaultEvent(
                    t * 86400.0, f"node{i:04d}", cat,
                    bool(rng.random() < self.straggler_frac)))
        out.sort(key=lambda e: e.t)
        return out


def correlated_domain_failure(member_nodes: Sequence[str], t: float,
                              domain: str, category: str = "network"
                              ) -> List[FaultEvent]:
    """One root cause (switch/rack/PDU) failing every member node at once."""
    return [FaultEvent(t, n, category, degrades_only=False, domain=domain)
            for n in member_nodes]


def cascade_events(primary: List[FaultEvent], nodes: Sequence[str],
                   p_cascade: float = 0.1, recovery_window_s: float = 600.0,
                   seed: int = 0,
                   weights: Optional[Mapping[str, float]] = None
                   ) -> List[FaultEvent]:
    """Sample follow-on faults landing inside each primary's recovery window.

    A cascading fault hits a *different* node shortly after a hard failure —
    the double-fault-during-restore case that forces restores down the
    waterfall (memory cache -> ring backup -> persistent store). Returns the
    combined, time-sorted schedule.

    Victim selection draws indices against the prebuilt node array (one
    fixed-size batch of draws for *all* primaries), not a per-primary rebuild
    of the candidate list — O(n_primaries) instead of O(n_primaries * n).
    """
    out = list(primary)
    n = len(nodes)
    if not primary or n == 0 or p_cascade <= 0:
        out.sort(key=lambda e: e.t)
        return out
    rng = np.random.default_rng(seed)
    cats = list(weights if weights is not None else FAULT_CATEGORIES)
    cumw = np.cumsum(category_weights(cats, weights))
    cumw[-1] = 1.0
    node_arr = list(nodes)                       # prebuilt victim array
    index_of = {name: i for i, name in enumerate(node_arr)}
    n_p = len(primary)
    # one fixed-size batch of draws per channel, consumed for every primary
    # (masked afterwards), so the stream depends only on (seed, n_primaries)
    u_trigger = rng.random(n_p)
    u_victim = rng.random(n_p)
    dt = rng.uniform(1.0, recovery_window_s, n_p)
    cat_ix = np.minimum(np.searchsorted(cumw, rng.random(n_p), side="right"),
                        len(cats) - 1)
    degrades = np.fromiter((e.degrades_only for e in primary), bool, n_p)
    self_ix = np.fromiter((index_of.get(e.node, -1) for e in primary),
                          np.int64, n_p)
    # a primary inside the pool can't cascade onto itself: n-1 candidates
    hi = np.where(self_ix >= 0, n - 1, n)
    fire = (~degrades) & (u_trigger < p_cascade) & (hi > 0)
    victim_ix = np.minimum((u_victim * hi).astype(np.int64), hi - 1)
    victim_ix = np.where((self_ix >= 0) & (victim_ix >= self_ix),
                         victim_ix + 1, victim_ix)
    for j in np.flatnonzero(fire):
        ev = primary[j]
        out.append(FaultEvent(ev.t + float(dt[j]), node_arr[victim_ix[j]],
                              cats[cat_ix[j]], degrades_only=False,
                              cascade_of=f"{ev.node}@{ev.t:.0f}"))
    out.sort(key=lambda e: e.t)
    return out


def domain_outage_schedule(topology, kind: str, mean_days: float,
                           horizon_days: float, seed: int = 0,
                           category: str = "network") -> List[FaultEvent]:
    """Per-domain correlated-outage schedule: each rack/switch fails as a
    whole at its own exponential rate (MTBF ``mean_days``), taking every
    member node down at one timestamp.

    This is the rate-driven generalisation of :func:`correlated_domain_failure`
    — instead of one scripted outage, whole-domain failures are sampled onto
    the timeline alongside the per-node ``FaultInjector`` schedule.
    """
    rng = np.random.default_rng(seed)
    domains = sorted({getattr(n, kind) for n in topology.nodes.values()})
    out: List[FaultEvent] = []
    for dom in domains:
        t = 0.0
        while True:
            t += float(rng.exponential(mean_days))
            if t >= horizon_days:
                break
            out.extend(correlated_domain_failure(
                topology.domain_members(kind, dom), t * 86400.0,
                domain=dom, category=category))
    out.sort(key=lambda e: e.t)
    return out


def merge_schedules(*schedules: Sequence[FaultEvent]) -> List[FaultEvent]:
    """Merge fault schedules into one time-sorted timeline."""
    out: List[FaultEvent] = [e for s in schedules for e in s]
    out.sort(key=lambda e: e.t)
    return out


def group_domain_incidents(drained: Sequence[Tuple[float, Any]]
                           ) -> List[List[Tuple[float, Any]]]:
    """Coalesce a drained event batch into incidents.

    Consecutive ``FaultEvent`` payloads sharing the same ``(t, domain)``
    (one correlated rack/switch outage, whose member events sit adjacently
    in the queue's stable FIFO order) form a single incident; everything
    else is a singleton. Within an incident, members keep their queue
    order, so dispatching an incident's members one at a time reproduces
    the ungrouped drain exactly.
    """
    groups: List[List[Tuple[float, Any]]] = []
    key = None
    for t, payload in drained:
        k = ((t, payload.domain)
             if isinstance(payload, FaultEvent) and payload.domain is not None
             else None)
        if k is not None and k == key:
            groups[-1].append((t, payload))
        else:
            groups.append([(t, payload)])
        key = k
    return groups


def push_schedule(queue: "EventQueue", events: Iterable[FaultEvent]) -> int:
    """Bridge a fault schedule onto an :class:`EventQueue`.

    Event times are interpreted relative to the queue clock's *current* time,
    so a schedule can be pushed onto a mid-run shared clock without rewriting
    timestamps. Returns the number of events pushed.
    """
    t0 = queue.clock.seconds
    return queue.push_batch((t0 + ev.t, ev) for ev in events)
