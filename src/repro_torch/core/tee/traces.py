"""Synthetic training-task traces matching the paper's Table I error taxonomy.

A trace is per-rank multi-metric time series (GPU util, HBM util, IB traffic,
NVLink traffic, host IO) with the three prior characteristics TEE exploits:
ranks are statistically consistent, each rank is periodic (fwd/bwd cadence),
and per-timestamp metric vectors are classifiable. Faults inject the
signatures observed in production: freezes flatline everything, stragglers
stretch the period on one node, crashes drop to zero, storage stalls spike IO
wait while compute idles, user-code errors emit log bursts then exit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# Single source of truth for the Table-I taxonomy: the same categories and
# signatures drive TOL's fault injector and this trace generator, so the
# detector is trained/exercised on exactly the fault model the cluster uses.
from repro_torch.sim.faults import FAULT_CATEGORIES  # noqa: F401  (re-exported)
from repro_torch.sim.faults import FaultEvent, SIGNATURES as _SIGNATURES

METRICS = ("gpu_util", "mem_util", "ib_tx", "nvlink_tx", "host_io")


@dataclass
class TaskTrace:
    metrics: np.ndarray                   # (n_ranks, T, n_metrics) in [0, 1]
    logs: List[Tuple[int, int, str, str]]  # (t, rank, level, message)
    label: Optional[str] = None           # fault category or None (normal)
    onset: Optional[int] = None           # anomaly start timestamp
    bad_ranks: Tuple[int, ...] = ()
    init_len: int = 0                     # initialization-phase prefix


class TraceGenerator:
    def __init__(self, n_ranks: int = 8, period: int = 20,
                 n_metrics: int = len(METRICS), seed: int = 0):
        self.n_ranks = n_ranks
        self.period = period
        self.n_metrics = n_metrics
        self.rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #
    def normal(self, T: int = 400, init_len: int = 40) -> TaskTrace:
        m = self._base(T, init_len)
        logs = self._info_logs(T)
        return TaskTrace(m, logs, None, None, (), init_len)

    def faulty(self, category: str, T: int = 400, init_len: int = 40,
               onset: Optional[int] = None,
               n_bad: int = 1,
               ranks: Optional[Tuple[int, ...]] = None) -> TaskTrace:
        """Generate a faulty trace. With ``ranks`` given, the fault signature
        is planted on exactly those ranks (instead of random ones) — used to
        replay injected :class:`FaultEvent`s through the detector."""
        assert category in _SIGNATURES, category
        m = self._base(T, init_len)
        onset = onset if onset is not None else int(
            self.rng.integers(init_len + 80, T - 80))
        if ranks is not None:
            bad = tuple(int(r) for r in ranks)
            if any(r < 0 or r >= self.n_ranks for r in bad):
                raise ValueError(f"ranks {bad} out of range for "
                                 f"n_ranks={self.n_ranks}")
        else:
            bad = tuple(self.rng.choice(self.n_ranks, size=n_bad,
                                        replace=False).tolist())
        logs = self._info_logs(T)
        sig = _SIGNATURES[category]
        if sig == "freeze":
            m[:, onset:, :] = m[:, onset:onset + 1, :] * 0.05 + 0.02
        elif sig == "crash":
            for r in bad:
                m[r, onset:, :] = 0.0
            m[:, onset + self.period:, :] *= 0.1   # rest of job stalls soon after
            logs += [(onset + 2, bad[0], "ERROR", "GPU ECC error: uncorrectable"),
                     (onset + 4, bad[0], "ERROR", "CUDA error: device-side assert")]
        elif sig == "io_stall":
            m[:, onset:, 4] = np.minimum(1.0, m[:, onset:, 4] + 0.9)  # io wait spikes
            m[:, onset:, 0] *= 0.15                                   # compute idles
            m[:, onset:, 2] *= 0.1
            logs += [(onset + i * 3, int(self.rng.integers(self.n_ranks)),
                      "ERROR", "storage read timeout: socket timeout") for i in range(6)]
        elif sig == "comm_drop":
            for r in bad:
                m[r, onset:, 2] *= 0.05                               # IB traffic dies
                m[r, onset:, 0] *= 0.4
            m[:, onset + 2 * self.period:, 0] *= 0.2                  # collective stalls
            logs += [(onset + 1, bad[0], "ERROR",
                      "NET/IB: Got completion from peer with error 12"),
                     (onset + 5, bad[0], "ERROR", "NCCL watchdog timeout")]
        elif sig == "straggler":
            # one slow rank: its fwd/bwd cadence stretches 2x and every other
            # rank stalls proportionally waiting at collectives (tail latency)
            for r in bad:
                t = np.arange(T - onset, dtype=np.float64)
                stretch = 0.5 + 0.45 * np.sign(
                    np.sin(2 * np.pi * t / (2 * self.period)))
                for k in range(self.n_metrics):
                    m[r, onset:, k] = np.clip(
                        0.15 + 0.6 * stretch
                        + self.rng.normal(0, 0.04, T - onset), 0, 1)
            others = [r for r in range(self.n_ranks) if r not in bad]
            m[others, onset:, 0] *= 0.55   # blocked at all-reduce
            m[others, onset:, 2] *= 0.55
        elif sig == "log_burst_exit":
            stop = min(onset + 3 * self.period, T)
            for r in bad:
                m[r, stop:, :] = 0.0
            m[:, stop:, :] *= 0.05
            logs += [(onset + i, bad[0], "ERROR",
                      ["Python Segmentation fault",
                       "torch.cuda.OutOfMemoryError: CUDA out of memory",
                       "AttributeError: 'NoneType' object",
                       "RuntimeError: CUDA error"][i % 4]) for i in range(12)]
        return TaskTrace(m, sorted(logs), category, onset, bad, init_len)

    def for_fault(self, category: str, bad_rank: int, T: int = 240,
                  init_len: int = 40, onset: int = 120,
                  degrades_only: bool = False) -> TaskTrace:
        """Trace for one *injected* fault: signature planted on the faulted
        rank, labelled with the injected category. Degradation-mode faults
        (flapping link, slow node) render as the straggler signature."""
        cat = category if category in _SIGNATURES else "other"
        if degrades_only:
            cat = "straggler"
        tr = self.faulty(cat, T=T, init_len=init_len, onset=onset,
                         ranks=(bad_rank,))
        tr.label = category
        return tr

    def from_event(self, ev: FaultEvent, bad_rank: int, T: int = 240,
                   init_len: int = 40, onset: int = 120) -> TaskTrace:
        """Trace for a kernel :class:`FaultEvent` (shared fault model)."""
        return self.for_fault(ev.category, bad_rank, T=T, init_len=init_len,
                              onset=onset, degrades_only=ev.degrades_only)

    def sample_category(self) -> str:
        cats = list(FAULT_CATEGORIES)
        w = np.array([FAULT_CATEGORIES[c] for c in cats], np.float64)
        return str(self.rng.choice(cats, p=w / w.sum()))

    # ------------------------------------------------------------------ #
    def _base(self, T: int, init_len: int) -> np.ndarray:
        t = np.arange(T, dtype=np.float64)
        m = np.empty((self.n_ranks, T, self.n_metrics))
        phase_r = self.rng.uniform(0, 2 * np.pi, self.n_ranks)
        for r in range(self.n_ranks):
            # fwd/bwd cadence: near-square periodic waves + noise, consistent
            # across ranks up to phase jitter
            base = 0.5 + 0.45 * np.sign(np.sin(2 * np.pi * t / self.period
                                               + phase_r[r] * 0.1))
            for k in range(self.n_metrics):
                lag = 0.4 * k
                wave = 0.5 + 0.4 * np.sign(np.sin(2 * np.pi * (t - lag) / self.period
                                                  + phase_r[r] * 0.1))
                noise = self.rng.normal(0, 0.04, T)
                m[r, :, k] = np.clip(0.15 + 0.75 * wave * (0.9 + 0.1 * base)
                                     + noise, 0, 1)
        # initialization phase: low, aperiodic, meaningless metrics
        m[:, :init_len, :] = np.clip(
            self.rng.uniform(0.0, 0.25, (self.n_ranks, init_len, self.n_metrics)), 0, 1)
        return m

    def _info_logs(self, T: int) -> List[Tuple[int, int, str, str]]:
        out = []
        for t in range(0, T, self.period):
            r = int(self.rng.integers(self.n_ranks))
            out.append((t, r, "INFO", f"step {t // self.period}: loss=2.3"))
        return out
