"""Ring-buffered per-job ingestion state for the streaming TEE.

A :class:`MetricRing` holds the last ``capacity`` per-rank metric samples of
one job in a fixed numpy buffer; a :class:`LogRing` holds the recent log
lines. Both support incremental appends and O(window) reads — the streaming
scorer never rescans a full trace, it only ever touches the samples inside
the window it is about to score.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Tuple

import numpy as np

LogEntry = Tuple[int, int, str, str]          # (t, rank, level, message)


class MetricRing:
    """Fixed-capacity ring of per-rank metric samples.

    Sample indices are absolute: the ``count``-th pushed column has index
    ``count`` (matching the timestamp axis of a ``TaskTrace``), so window
    reads line up exactly with the batch detector's ``[t0, t1)`` slices.
    """

    def __init__(self, n_ranks: int, n_metrics: int, capacity: int):
        assert capacity > 0
        self.n_ranks = n_ranks
        self.n_metrics = n_metrics
        self.cap = capacity
        self._buf = np.zeros((n_ranks, capacity, n_metrics))
        self._head = 0                         # next write slot
        self.count = 0                         # samples ever pushed

    def push(self, cols: np.ndarray) -> None:
        """Append samples. ``cols``: (n_ranks, k, n_metrics) or a single
        (n_ranks, n_metrics) column."""
        cols = np.asarray(cols, np.float64)
        if cols.ndim == 2:
            cols = cols[:, None, :]
        k = cols.shape[1]
        if k >= self.cap:                      # only the tail survives
            self._buf[:] = cols[:, -self.cap:, :]
            self._head = 0
            self.count += k
            return
        end = self._head + k
        if end <= self.cap:
            self._buf[:, self._head:end, :] = cols
        else:
            split = self.cap - self._head
            self._buf[:, self._head:, :] = cols[:, :split, :]
            self._buf[:, :end - self.cap, :] = cols[:, split:, :]
        self._head = end % self.cap
        self.count += k

    def window(self, w: int) -> np.ndarray:
        """The latest ``min(w, count, capacity)`` samples, oldest first:
        (n_ranks, w, n_metrics). Covers absolute indices
        [count - w, count)."""
        w = min(w, self.count, self.cap)
        start = (self._head - w) % self.cap
        if start + w <= self.cap:
            return self._buf[:, start:start + w, :]
        return np.concatenate([self._buf[:, start:, :],
                               self._buf[:, :(start + w) % self.cap, :]],
                              axis=1)


class LogRing:
    """Recent log lines, pruned by sample-time horizon."""

    def __init__(self, horizon: int = 512):
        self.horizon = horizon
        self._logs: Deque[LogEntry] = deque()

    def push(self, entries: List[LogEntry]) -> None:
        self._logs.extend(entries)
        if not self._logs:
            return
        newest = max(e[0] for e in entries) if entries else self._logs[-1][0]
        while self._logs and self._logs[0][0] < newest - self.horizon:
            self._logs.popleft()

    def window(self, t0: int, t1: int) -> List[LogEntry]:
        return [e for e in self._logs if t0 <= e[0] < t1]
