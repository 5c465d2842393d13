"""The one simulation clock + a discrete-event queue.

``SimClock`` accumulates *modelled* seconds: real work (memcpys, disk writes)
runs at native speed while bandwidth/latency models charge what the same
operation would cost on the paper's cluster. Every subsystem in a scenario
shares one instance — the identity is asserted by tests — so TCE transfer
costs, TOL recovery phases and DES fault timelines land on a single
monotonically consistent timeline.

``EventQueue`` is a minimal discrete-event heap keyed on modelled time. Pops
optionally advance the bound clock, which keeps "time never runs backwards"
true by construction, and ``run_until`` is the canonical event loop: it drains
events in timestamp order, advancing the clock to each event *before* its
handler runs, so a handler can never observe a clock behind the event it is
handling (the soak engine asserts exactly this).
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Callable, Iterable, List, Optional, Tuple


class SimClock:
    """Accumulates modelled seconds (thread-safe, monotonic)."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)
        self._lock = threading.Lock()

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"clock cannot run backwards ({seconds} s)")
        with self._lock:
            self._t += seconds

    def advance_to(self, t: float) -> None:
        """Jump forward to absolute modelled time ``t`` (no-op if in the past)."""
        with self._lock:
            self._t = max(self._t, float(t))

    @property
    def seconds(self) -> float:
        return self._t

    def reset(self) -> None:
        with self._lock:
            self._t = 0.0


class EventQueue:
    """Min-heap of (time, payload) events on a shared :class:`SimClock`.

    Payloads are opaque (fault events, callables, ...); FIFO order is
    preserved among events scheduled for the same instant.
    """

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock or SimClock()
        self._heap: List[Tuple[float, int, Any]] = []
        self._seq = itertools.count()

    def push(self, t: float, payload: Any) -> None:
        heapq.heappush(self._heap, (float(t), next(self._seq), payload))

    def push_batch(self, items: Iterable[Tuple[float, Any]]) -> int:
        """Bulk-load ``(t, payload)`` pairs: one O(n) heapify instead of n
        heappushes. Sequence numbers are handed out in input order, so the
        same-timestamp FIFO tie-break matches sequential :meth:`push` calls.
        """
        h = self._heap
        n0 = len(h)
        h.extend((float(t), next(self._seq), p) for t, p in items)
        heapq.heapify(h)
        return len(h) - n0

    def push_after(self, delay: float, payload: Any) -> None:
        self.push(self.clock.seconds + delay, payload)

    def peek_time(self) -> float:
        return self._heap[0][0] if self._heap else float("inf")

    def peek(self) -> Tuple[float, Any]:
        """The earliest event without popping it (same tie-break as pop)."""
        if not self._heap:
            raise IndexError("peek into empty EventQueue")
        t, _, payload = self._heap[0]
        return t, payload

    def pop(self, advance_clock: bool = False) -> Tuple[float, Any]:
        """Pop the earliest event; optionally advance the clock to its time."""
        if not self._heap:
            raise IndexError("pop from empty EventQueue")
        t, _, payload = heapq.heappop(self._heap)
        if advance_clock:
            self.clock.advance_to(t)
        return t, payload

    def pop_batch(self, advance_clock: bool = False
                  ) -> Tuple[float, List[Any]]:
        """Pop *every* event due at the earliest timestamp in one call.

        Tie-break: among events at the same timestamp, payloads come back in
        push (FIFO) order — exactly the order repeated :meth:`pop` calls
        would return them, so a batch drain and a one-at-a-time drain see
        the same sequence. Returns ``(t, [payload, ...])``.
        """
        if not self._heap:
            raise IndexError("pop_batch from empty EventQueue")
        t0 = self._heap[0][0]
        out: List[Any] = []
        while self._heap and self._heap[0][0] == t0:
            out.append(heapq.heappop(self._heap)[2])
        if advance_clock:
            self.clock.advance_to(t0)
        return t0, out

    def pop_due(self, t: Optional[float] = None,
                advance_clock: bool = False) -> List[Tuple[float, Any]]:
        """Pop every event with time <= t (default: the clock's now).

        With ``advance_clock=True`` the clock rides along: it is advanced to
        each popped event's timestamp (and finally to ``t`` itself), so a
        caller draining a future window can never observe the clock *behind*
        an event it just popped — the monotonicity contract ``run_until``
        and the soak loop assert.
        """
        cutoff = self.clock.seconds if t is None else t
        out: List[Tuple[float, Any]] = []
        while self._heap and self._heap[0][0] <= cutoff:
            out.append(self.pop(advance_clock=advance_clock))
        if advance_clock:
            self.clock.advance_to(cutoff)
        return out

    def run_until(self, t_end: float,
                  handler: Optional[Callable[[float, Any], None]] = None
                  ) -> int:
        """Event loop: drain events with time <= ``t_end`` in order.

        The clock is advanced to each event's timestamp *before* the handler
        sees it (time never runs backwards relative to the event being
        handled). Handlers may push new events — cascades scheduled inside
        the window are picked up in the same drain. Finally the clock lands
        exactly on ``t_end``. Returns the number of events handled.
        """
        n = 0
        while self._heap and self._heap[0][0] <= t_end:
            t, payload = self.pop(advance_clock=True)
            assert self.clock.seconds >= t, \
                f"clock {self.clock.seconds} behind popped event at {t}"
            if handler is not None:
                handler(t, payload)
            n += 1
        self.clock.advance_to(t_end)
        return n

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
