"""Launcher lifecycle finite-state machine (paper §IV-A, Fig. 1 steps 1-11).

    INIT -> WARMUP -> RUNNING -> CHECKING -> RECOVER_INPLACE  -> WARMUP
                          |                  RESCHEDULING     -> WARMUP
                          +-> DONE / FAILED

Transitions are validated against an explicit table; every transition is
recorded (state history is what the unattended closed loop is audited by).
With a shared :class:`~repro.sim.clock.SimClock` bound, history timestamps
are deterministic *modelled* seconds on the substrate's one timeline;
without one they fall back to wall clock (standalone use).
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.sim.clock import SimClock


class JobState(enum.Enum):
    INIT = "init"
    WARMUP = "warmup"
    RUNNING = "running"
    CHECKING = "checking"
    RECOVER_INPLACE = "recover_inplace"
    RESCHEDULING = "rescheduling"
    DONE = "done"
    FAILED = "failed"


_TRANSITIONS: Dict[JobState, Tuple[JobState, ...]] = {
    JobState.INIT: (JobState.WARMUP, JobState.FAILED),
    JobState.WARMUP: (JobState.RUNNING, JobState.CHECKING, JobState.FAILED),
    JobState.RUNNING: (JobState.CHECKING, JobState.DONE, JobState.FAILED),
    JobState.CHECKING: (JobState.RECOVER_INPLACE, JobState.RESCHEDULING,
                        JobState.FAILED),
    JobState.RECOVER_INPLACE: (JobState.WARMUP, JobState.FAILED),
    JobState.RESCHEDULING: (JobState.WARMUP, JobState.FAILED),
    JobState.DONE: (),
    JobState.FAILED: (),
}


class TransitionError(Exception):
    pass


@dataclass
class LauncherFSM:
    state: JobState = JobState.INIT
    history: List[Tuple[float, JobState, str]] = field(default_factory=list)
    on_enter: Dict[JobState, Callable] = field(default_factory=dict)
    clock: Optional[SimClock] = None    # shared substrate clock, if any

    def __post_init__(self):
        self.history.append((self._now(), self.state, "start"))

    def _now(self) -> float:
        return self.clock.seconds if self.clock is not None else time.time()

    def to(self, new: JobState, reason: str = "") -> None:
        if new not in _TRANSITIONS[self.state]:
            raise TransitionError(f"{self.state.value} -/-> {new.value} ({reason})")
        self.state = new
        self.history.append((self._now(), new, reason))
        hook = self.on_enter.get(new)
        if hook is not None:
            hook(reason)

    @property
    def terminal(self) -> bool:
        return self.state in (JobState.DONE, JobState.FAILED)

    def restarts(self) -> int:
        return sum(1 for _, s, _ in self.history
                   if s in (JobState.RECOVER_INPLACE, JobState.RESCHEDULING))
