"""The closed-loop orchestrator's phase costs (``repro.core.tol.orchestrator``
is the reference).

Only :class:`PhaseCosts` is ported so far: the shared recovery driver
(:mod:`repro_torch.substrate.driver`) charges its modelled downtime with it.
``TransomOperator``, ``JobConfig`` and ``JobReport`` run on the TCE engine and
the TEE, and come with them.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PhaseCosts:
    """Modeled seconds per recovery phase (calibrated to the paper's claims:
    average restart ~10-12 min with TRANSOM vs hours-to-days manual)."""
    tee_detect: float = 15.0
    error_check: float = 90.0
    evict_reschedule: float = 360.0
    inplace_restart: float = 120.0
    warmup: float = 60.0
    restore_from_cache: float = 10.0
    restore_from_backup: float = 16.0
