"""Anomaly detectors — numpy implementations of the paper's model set.

* LOF            — density-based outlier factor over per-timestamp metric
                   vectors (Breunig et al. 2000), novelty mode: test points
                   are scored against the fitted normal population.
* NeighborProfile— KNN matrix profile (He et al., ICDE'20): each test
                   subsequence's anomaly score is its mean z-normalised
                   distance to its k nearest training subsequences; the
                   paper's fix for plain matrix profile's single-neighbor
                   brittleness.
* DTWKNNCluster  — cross-rank consistency: pairwise Dynamic Time Warping
                   distances between ranks; a rank far from the cluster is
                   flagged (used for node attribution).
* LogDetector    — sliding-window error-log counting + first-error-node
                   attribution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# --------------------------------------------------------------------------- #
# LOF
# --------------------------------------------------------------------------- #
class LOF:
    """Local Outlier Factor with novelty scoring."""

    def __init__(self, k: int = 10):
        self.k = k
        self._fit: Optional[np.ndarray] = None
        self._lrd_fit: Optional[np.ndarray] = None
        self._kdist_fit: Optional[np.ndarray] = None

    @staticmethod
    def _dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return np.sqrt(np.maximum(
            np.sum(a * a, 1)[:, None] + np.sum(b * b, 1)[None, :]
            - 2 * a @ b.T, 0.0))

    def fit(self, x: np.ndarray) -> "LOF":
        """x: (n, d) normal points."""
        x = np.asarray(x, np.float64)
        self._fit = x
        d = self._dists(x, x)
        np.fill_diagonal(d, np.inf)
        k = min(self.k, x.shape[0] - 1)
        idx = np.argsort(d, axis=1)[:, :k]
        kd = np.take_along_axis(d, idx, 1)
        self._kdist_fit = kd[:, -1]                         # k-distance
        reach = np.maximum(kd, self._kdist_fit[idx])        # reach-dist
        self._lrd_fit = 1.0 / (np.mean(reach, 1) + 1e-12)
        return self

    def score(self, x: np.ndarray) -> np.ndarray:
        """LOF of each test point w.r.t. the fitted set (>~1.5 = outlier)."""
        assert self._fit is not None, "call fit() first"
        x = np.asarray(x, np.float64)
        d = self._dists(x, self._fit)
        k = min(self.k, self._fit.shape[0] - 1)
        idx = np.argsort(d, axis=1)[:, :k]
        kd = np.take_along_axis(d, idx, 1)
        reach = np.maximum(kd, self._kdist_fit[idx])
        lrd = 1.0 / (np.mean(reach, 1) + 1e-12)
        return np.mean(self._lrd_fit[idx], 1) / (lrd + 1e-12)

    def score_batch(self, x: np.ndarray, chunk: int = 384) -> np.ndarray:
        """Fleet-scale scoring: same values as :meth:`score` (every
        reduction over the k-NN set is order-free, and partitioning squared
        distances selects the same neighbours as sorting true distances)
        without the full-row argsort or one giant distance matrix —
        chunked so temporaries stay cache-sized at 100k+ test points."""
        assert self._fit is not None, "call fit() first"
        x = np.asarray(x, np.float64)
        n = x.shape[0]
        k = min(self.k, self._fit.shape[0] - 1)
        fit_sq = np.sum(self._fit * self._fit, 1)[None, :]
        out = np.empty(n)
        for c0 in range(0, n, chunk):
            xc = x[c0:c0 + chunk]
            d2 = np.maximum(np.sum(xc * xc, 1)[:, None] + fit_sq
                            - 2 * xc @ self._fit.T, 0.0)
            idx = np.argpartition(d2, k - 1, axis=1)[:, :k]
            kd = np.sqrt(np.take_along_axis(d2, idx, 1))
            reach = np.maximum(kd, self._kdist_fit[idx])
            lrd = 1.0 / (np.mean(reach, 1) + 1e-12)
            out[c0:c0 + chunk] = np.mean(self._lrd_fit[idx], 1) / (lrd + 1e-12)
        return out


# --------------------------------------------------------------------------- #
# KNN matrix profile (NeighborProfile)
# --------------------------------------------------------------------------- #
def _znorm_subsequences(x: np.ndarray, m: int) -> np.ndarray:
    """All length-m subsequences of 1-D x, z-normalised. -> (n-m+1, m)."""
    n = x.shape[0] - m + 1
    if n <= 0:
        return np.zeros((0, m))
    subs = np.lib.stride_tricks.sliding_window_view(x, m).astype(np.float64)
    mu = subs.mean(1, keepdims=True)
    sd = subs.std(1, keepdims=True)
    return (subs - mu) / np.maximum(sd, 1e-6)


class NeighborProfile:
    """Bagged k-NN subsequence distance profile."""

    def __init__(self, m: int = 40, k: int = 5, max_train: int = 4096):
        self.m = m
        self.k = k
        self.max_train = max_train
        self._bank: Optional[np.ndarray] = None

    def fit(self, series: Sequence[np.ndarray]) -> "NeighborProfile":
        subs = [_znorm_subsequences(np.asarray(s, np.float64), self.m)
                for s in series]
        bank = np.concatenate([s for s in subs if len(s)], 0)
        if bank.shape[0] > self.max_train:
            sel = np.random.default_rng(0).choice(bank.shape[0],
                                                  self.max_train, replace=False)
            bank = bank[sel]
        self._bank = bank
        return self

    def score(self, x: np.ndarray) -> np.ndarray:
        """Per-subsequence anomaly score of 1-D series x."""
        assert self._bank is not None, "call fit() first"
        q = _znorm_subsequences(np.asarray(x, np.float64), self.m)
        if q.shape[0] == 0:
            return np.zeros((0,))
        d = np.sqrt(np.maximum(
            np.sum(q * q, 1)[:, None] + np.sum(self._bank * self._bank, 1)[None, :]
            - 2 * q @ self._bank.T, 0.0))
        k = min(self.k, self._bank.shape[0])
        nn = np.sort(d, 1)[:, :k]
        return nn.mean(1) / np.sqrt(self.m)

    def score_batch(self, xs: np.ndarray, chunk: int = 512) -> np.ndarray:
        """Per-subsequence scores for a whole batch of 1-D series at once.

        ``xs``: (B, T) -> (B, n_sub); row ``b`` equals ``score(xs[b])``.
        Partitions *squared* distances (sqrt is monotone, so the k-NN set
        is identical) and chunks the query rows so the distance matrix
        never exceeds cache-friendly size at fleet scale.
        """
        assert self._bank is not None, "call fit() first"
        xs = np.asarray(xs, np.float64)
        B, T = xs.shape
        n_sub = T - self.m + 1
        if n_sub <= 0:
            return np.zeros((B, 0))
        subs = np.lib.stride_tricks.sliding_window_view(
            xs, self.m, axis=1).astype(np.float64)
        mu = subs.mean(-1, keepdims=True)
        sd = subs.std(-1, keepdims=True)
        q = ((subs - mu) / np.maximum(sd, 1e-6)).reshape(B * n_sub, self.m)
        bank_sq = np.sum(self._bank * self._bank, 1)[None, :]
        k = min(self.k, self._bank.shape[0])
        out = np.empty(B * n_sub)
        for c0 in range(0, q.shape[0], chunk):
            qc = q[c0:c0 + chunk]
            d2 = np.maximum(np.sum(qc * qc, 1)[:, None] + bank_sq
                            - 2 * qc @ self._bank.T, 0.0)
            nn2 = np.partition(d2, k - 1, axis=1)[:, :k]
            out[c0:c0 + chunk] = np.sqrt(nn2).mean(1) / np.sqrt(self.m)
        return out.reshape(B, n_sub)


# --------------------------------------------------------------------------- #
# DTW + KNN clustering across ranks
# --------------------------------------------------------------------------- #
def dtw_distance(a: np.ndarray, b: np.ndarray, window: int = 10) -> float:
    """Sakoe-Chiba banded DTW between 1-D series."""
    n, m = len(a), len(b)
    w = max(window, abs(n - m))
    inf = np.inf
    prev = np.full(m + 1, inf)
    prev[0] = 0.0
    for i in range(1, n + 1):
        cur = np.full(m + 1, inf)
        lo, hi = max(1, i - w), min(m, i + w)
        for j in range(lo, hi + 1):
            c = (a[i - 1] - b[j - 1]) ** 2
            cur[j] = c + min(prev[j], cur[j - 1], prev[j - 1])
        prev = cur
    return float(np.sqrt(prev[m]))


class DTWKNNCluster:
    """Flag ranks whose series diverge from the cluster consensus."""

    def __init__(self, window: int = 10, z_thresh: float = 3.0,
                 downsample: int = 4):
        self.window = window
        self.z_thresh = z_thresh
        self.ds = downsample

    def rank_scores(self, series: np.ndarray) -> np.ndarray:
        """series: (n_ranks, T). Returns mean DTW distance of each rank to
        the others (consistency score)."""
        x = series[:, ::self.ds]
        n = x.shape[0]
        d = np.zeros((n, n))
        for i in range(n):
            for j in range(i + 1, n):
                d[i, j] = d[j, i] = dtw_distance(x[i], x[j], self.window)
        return d.sum(1) / max(n - 1, 1)

    def outlier_ranks(self, series: np.ndarray) -> List[int]:
        s = self.rank_scores(series)
        med = np.median(s)
        mad = np.median(np.abs(s - med)) + 1e-9
        z = (s - med) / (1.4826 * mad)
        return [int(i) for i in np.where(z > self.z_thresh)[0]]


# --------------------------------------------------------------------------- #
# Vectorized batch consistency (the fleet-scale streaming path)
# --------------------------------------------------------------------------- #
def rank_deviation_scores(series: np.ndarray) -> np.ndarray:
    """Vectorized cross-rank consistency scores.

    ``series``: (..., n_ranks, T) activity. Each rank's series is
    z-normalised (the same normalisation DTW effectively compares under)
    and scored by its RMS deviation from the cross-rank median profile —
    the batched stand-in for :meth:`DTWKNNCluster.rank_scores`: identical
    "far from the cluster consensus" semantics, one numpy pass over
    jobs x ranks x time instead of a per-pair Python DTW loop.
    """
    x = np.asarray(series, np.float64)
    mu = x.mean(-1, keepdims=True)
    sd = np.maximum(x.std(-1, keepdims=True), 1e-6)
    z = (x - mu) / sd
    consensus = np.median(z, axis=-2, keepdims=True)
    return np.sqrt(np.mean((z - consensus) ** 2, axis=-1))


def consistency_outlier_mask(series: np.ndarray,
                             z_thresh: float = 3.0) -> np.ndarray:
    """(..., n_ranks, T) -> bool (..., n_ranks): ranks whose deviation
    score is a robust-z outlier among their job's ranks (the same
    median/MAD rule as :meth:`DTWKNNCluster.outlier_ranks`)."""
    s = rank_deviation_scores(series)
    med = np.median(s, axis=-1, keepdims=True)
    mad = np.median(np.abs(s - med), axis=-1, keepdims=True) + 1e-9
    z = (s - med) / (1.4826 * mad)
    return z > z_thresh


def flatline_mask(activity: np.ndarray, frac: float = 0.25) -> np.ndarray:
    """(..., n_ranks, W) raw activity -> bool (..., n_ranks): ranks whose
    mean activity collapses below ``frac`` x the job median while the
    median itself stays alive — the batched form of
    ``TEEService._flatline_ranks`` (median < 0.1 means the whole job is
    down: a job-level event, so no rank is singled out)."""
    act = np.asarray(activity, np.float64)
    level = act.mean(-1)
    med = np.median(level, axis=-1, keepdims=True)
    return (level < frac * med) & (med >= 0.1)


# --------------------------------------------------------------------------- #
# Log detector
# --------------------------------------------------------------------------- #
ERROR_PATTERNS = ("ERROR", "error", "Traceback", "CUDA error", "NCCL",
                  "timeout", "Segmentation fault", "OutOfMemory", "ECC")


@dataclass
class LogVerdict:
    anomalous: bool
    err_count: int
    first_error_rank: Optional[int]
    first_error_t: Optional[int]


class LogDetector:
    """Sliding-window error-log counting; the first error's node is the
    prime suspect (paper: 'the node that first produces error logs is often
    the actual anomalous node')."""

    def __init__(self, threshold: int = 3):
        self.threshold = threshold

    @staticmethod
    def is_error(level: str, msg: str) -> bool:
        return level == "ERROR" or any(p in msg for p in ERROR_PATTERNS[2:])

    def detect(self, logs: List[Tuple[int, int, str, str]],
               t0: int, t1: int) -> LogVerdict:
        errs = [(t, r) for (t, r, level, msg) in logs
                if t0 <= t < t1 and self.is_error(level, msg)]
        if not errs:
            return LogVerdict(False, 0, None, None)
        errs.sort()
        return LogVerdict(len(errs) >= self.threshold, len(errs),
                          errs[0][1], errs[0][0])
