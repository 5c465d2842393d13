"""Planner-driven checkpoint-cadence adaptation (Chameleon-style).

The :class:`CadenceController` watches the rollback cost of each recovery
(lost work + restore leg, in modelled seconds) and tightens the save
interval when recent rollbacks run hot against the run's own baseline —
then relaxes back toward the configured interval once rollbacks cool
down. Every adaptation is recorded into the planner's
:class:`~repro.recovery.planner.DecisionLog`, so the decision log shows
*why* the cadence moved (the observed costs) next to every other
recovery decision.

Deterministic by construction: pure arithmetic over the observed
sequence, no clock reads, no randomness.
"""
from __future__ import annotations

from typing import List, Optional

from .planner import DecisionLog

CADENCE_ADAPT = "cadence_adapt"


class CadenceController:
    """Windowed rollback-cost controller for one job's save interval."""

    def __init__(self, base_interval_s: float, *,
                 min_interval_s: Optional[float] = None,
                 window: int = 4, tighten_ratio: float = 1.5,
                 log: Optional[DecisionLog] = None):
        self.base_interval_s = float(base_interval_s)
        self.interval_s = float(base_interval_s)
        self.min_interval_s = (min_interval_s if min_interval_s is not None
                               else base_interval_s / 8.0)
        self.window = max(int(window), 2)
        self.tighten_ratio = tighten_ratio
        self.log = log
        self._costs: List[float] = []
        self._baseline: Optional[float] = None
        self.adaptions = 0

    def observe_incident(self, t: float, rollback_cost_s: float) -> float:
        """Feed one recovery's rollback cost; returns the (possibly
        adapted) save interval to use from now on."""
        self._costs.append(float(rollback_cost_s))
        if self._baseline is None:
            if len(self._costs) >= max(self.window // 2, 2):
                self._baseline = (sum(self._costs) / len(self._costs))
            return self.interval_s
        recent = self._costs[-self.window:]
        mean = sum(recent) / len(recent)
        old = self.interval_s
        if mean > self.tighten_ratio * self._baseline:
            self.interval_s = max(self.min_interval_s, self.interval_s * 0.5)
        elif mean < self._baseline:
            self.interval_s = min(self.base_interval_s,
                                  self.interval_s * 1.25)
        if self.interval_s != old:
            self.adaptions += 1
            if self.log is not None:
                self.log.record({
                    "t": round(t, 3),
                    "kind": "cadence",
                    "decision": CADENCE_ADAPT,
                    "interval_s": [round(old, 1), round(self.interval_s, 1)],
                    "recent_rollback_s": round(mean, 1),
                    "baseline_rollback_s": round(self._baseline, 1),
                })
        return self.interval_s

    def to_report(self) -> dict:
        return {"initial_s": round(self.base_interval_s, 1),
                "final_s": round(self.interval_s, 1),
                "adaptions": self.adaptions}
