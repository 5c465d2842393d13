"""Cross-job anomaly correlation by failure domain.

One degrading switch shows up in every job whose ranks traverse it. Without
correlation the fleet would open N independent recoveries for one hardware
event; the correlator joins anomalies that name the same ``Topology``
failure domain within a correlation window into a single
:class:`DomainIncident`, handled once, with the member confidences combined
as independent evidence (more jobs seeing the same switch degrade = higher
attribution confidence).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .stream import JobAnomaly, combine_confidences


@dataclass
class DomainIncident:
    """One hardware event, as reconstructed from N jobs' streams."""
    t_open: float                     # earliest member detection time
    domain: str
    jobs: Tuple[str, ...]
    victims: Tuple[str, ...]          # union of attributed nodes
    confidence: float                 # combined: 1 - prod(1 - c_i)
    n_anomalies: int
    categories: Tuple[str, ...]


@dataclass
class _Group:
    t_open: float
    deadline: float
    members: List[JobAnomaly] = field(default_factory=list)


class CrossJobCorrelator:
    """Groups streamed :class:`JobAnomaly`s by failure domain.

    ``add`` opens a group per domain and returns the flush deadline when a
    new group opens (the caller schedules a ``flush(domain)`` wake then —
    DES-friendly: no polling); anomalies joining an open group return None.
    """

    def __init__(self, window_s: float = 900.0):
        self.window_s = window_s
        self._open: Dict[str, _Group] = {}
        self.incidents: List[DomainIncident] = []

    def add(self, anomaly: JobAnomaly) -> Optional[float]:
        g = self._open.get(anomaly.domain)
        if g is not None and anomaly.t_detect <= g.deadline:
            g.members.append(anomaly)
            return None
        if g is not None:             # stale group never flushed: close it
            self.flush(anomaly.domain)
        g = _Group(t_open=anomaly.t_detect,
                   deadline=anomaly.t_detect + self.window_s,
                   members=[anomaly])
        self._open[anomaly.domain] = g
        return g.deadline

    def flush(self, domain: str) -> Optional[DomainIncident]:
        g = self._open.pop(domain, None)
        if g is None or not g.members:
            return None
        members = sorted(g.members, key=lambda a: (a.t_detect, a.job))
        victims: List[str] = []
        for a in members:
            victims.extend(v for v in a.victims if v not in victims)
        inc = DomainIncident(
            t_open=members[0].t_detect,
            domain=domain,
            jobs=tuple(a.job for a in members),
            victims=tuple(victims),
            confidence=combine_confidences([a.confidence for a in members]),
            n_anomalies=len(members),
            categories=tuple(sorted({a.category for a in members})))
        self.incidents.append(inc)
        return inc
