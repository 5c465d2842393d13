"""TEE online detecting subsystem.

Periodically scores each running task's latest window with the model ensemble
(Algorithm 1): the task is anomalous when the log detector fires OR the metric
ensemble agrees (>= 2 votes of LOF / NeighborProfile / DTW-cluster). Node
attribution combines the first-error-log rank, DTW outlier ranks, and a
flatline heuristic for crashed ranks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from .detectors import DTWKNNCluster, LogDetector
from .trainer import TEEModels, _agg_series, _window_features
from .traces import TaskTrace


@dataclass
class TEEVerdict:
    anomalous: bool
    votes: Dict[str, bool]
    bad_ranks: Tuple[int, ...] = ()
    window: Tuple[int, int] = (0, 0)
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def metric_votes(self) -> int:
        return sum(self.votes.get(k, False) for k in ("lof", "nprofile", "cluster"))


class TEEService:
    def __init__(self, models: TEEModels, log_threshold: int = 3,
                 cluster: Optional[DTWKNNCluster] = None):
        self.m = models
        self.log_det = LogDetector(log_threshold)
        self.cluster = cluster or DTWKNNCluster()

    # ------------------------------------------------------------------ #
    def detect_window(self, trace: TaskTrace, t0: int, t1: int) -> TEEVerdict:
        """Score one [t0, t1) window (absolute timestamps incl. init)."""
        return self.score_window(trace.metrics[:, t0:t1, :], trace.logs,
                                 t0, t1)

    def score_window(self, win: np.ndarray,
                     logs: List[Tuple[int, int, str, str]],
                     t0: int, t1: int) -> TEEVerdict:
        """Score one already-sliced window: ``win`` is the raw
        (n_ranks, t1-t0, n_metrics) slice, ``logs`` any superset of the
        job's logs (filtered to [t0, t1) here). This is the entrypoint the
        streaming scorer (:mod:`repro.tee_stream`) feeds ring-buffered
        windows through — same math as :meth:`detect_window`."""
        m = self.m.pre.apply(win, 0)
        votes: Dict[str, bool] = {}
        detail: Dict[str, float] = {}

        feats = _window_features(m)
        lof_scores = self.m.lof.score(feats)
        frac = float(np.mean(lof_scores > self.m.lof_thresh))
        votes["lof"] = frac > 0.2
        detail["lof_frac"] = frac
        detail["lof_max"] = float(lof_scores.max()) if len(lof_scores) else 0.0

        s = _agg_series(m)
        np_scores = self.m.nprofile.score(s)
        np_max = float(np_scores.max()) if len(np_scores) else 0.0
        votes["nprofile"] = np_max > self.m.np_thresh
        detail["np_max"] = np_max

        out_ranks = self.cluster.outlier_ranks(m[:, :, 0])
        votes["cluster"] = len(out_ranks) > 0

        lv = self.log_det.detect(logs, t0, t1)
        votes["log"] = lv.anomalous
        detail["err_count"] = float(lv.err_count)

        metric_votes = sum(votes[k] for k in ("lof", "nprofile", "cluster"))
        anomalous = votes["log"] or metric_votes >= 2

        bad: List[int] = []
        if lv.first_error_rank is not None:
            bad.append(lv.first_error_rank)
        bad += [r for r in out_ranks if r not in bad]
        bad += [r for r in self._flatline_ranks(win) if r not in bad]
        return TEEVerdict(anomalous, votes, tuple(bad), (t0, t1), detail)

    @staticmethod
    def window_starts(T: int, init_len: int, window: int,
                      stride: int) -> range:
        """The scan schedule shared by batch :meth:`detect_task` and the
        streaming scorer (:mod:`repro.tee_stream`): window starts from
        ``init_len`` stepping by ``stride`` while a (possibly clipped)
        window fits — keeping both paths firing on identical windows is a
        pinned contract (tests/test_tee.py)."""
        return range(init_len, max(T - window + 1, init_len + 1), stride)

    def detect_task(self, trace: TaskTrace, stride: Optional[int] = None
                    ) -> TEEVerdict:
        """Scan a whole trace window-by-window; return the first firing
        verdict (or the last quiet one)."""
        w = self.m.window
        stride = stride or w // 2
        T = trace.metrics.shape[1]
        last = TEEVerdict(False, {}, (), (0, 0))
        for t0 in self.window_starts(T, trace.init_len, w, stride):
            v = self.detect_window(trace, t0, min(t0 + w, T))
            if v.anomalous:
                return v
            last = v
        return last

    # ------------------------------------------------------------------ #
    @staticmethod
    def _flatline_ranks(metrics: np.ndarray, frac: float = 0.25) -> List[int]:
        """Ranks whose activity dies while the cluster median stays alive."""
        act = metrics[:, :, 0]
        rank_level = act.mean(1)
        med = np.median(rank_level)
        if med < 0.1:       # everyone is dead -> job-level, not node-level
            return []
        return [int(r) for r in np.where(rank_level < frac * med)[0]]
