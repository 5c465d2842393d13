"""Vectorized fleet-scale detector evaluation.

One numpy pass scores a whole stack of jobs' metric windows —
(n_jobs, n_ranks, W, n_metrics) — against the fitted TEE ensemble:

* LOF over every job's per-timestep cross-rank features in ONE
  ``LOF.score`` call on the flattened (n_jobs*W, 2*n_metrics) batch;
* NeighborProfile over every job's aggregate activity series in ONE
  ``NeighborProfile.score_batch`` call;
* cross-rank consistency via :func:`~repro.core.tee.detectors.
  rank_deviation_scores` — the vectorized stand-in for the per-pair
  Python DTW loop (same "far from the cluster consensus" robust-z rule);
* flatline attribution via the batched
  :func:`~repro.core.tee.detectors.flatline_mask`.

The per-job/per-rank Python reference (:func:`loop_score_windows`)
computes the identical quantities rank by rank — it exists so the
vectorized path's speedup is measurable as a same-machine A/B
(``benchmarks/tee_bench.py`` gates it) and its outputs are pinned equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.tee.detectors import (LogVerdict, consistency_outlier_mask,
                                      flatline_mask, rank_deviation_scores)
from repro_torch.core.tee.service import TEEVerdict
from repro_torch.core.tee.trainer import TEEModels

# the metric-ensemble vote rule shared with TEEService.score_window
LOF_FRAC_VOTE = 0.2


@dataclass
class BatchVerdicts:
    """Per-job detector outputs for one window stride across the fleet."""
    lof_frac: np.ndarray          # (n_jobs,) fraction of LOF-flagged steps
    np_max: np.ndarray            # (n_jobs,) max NeighborProfile score
    lof_vote: np.ndarray          # (n_jobs,) bool
    np_vote: np.ndarray           # (n_jobs,) bool
    cluster_vote: np.ndarray      # (n_jobs,) bool
    outlier_mask: np.ndarray      # (n_jobs, n_ranks) consistency outliers
    flat_mask: np.ndarray         # (n_jobs, n_ranks) flatlined ranks

    @property
    def metric_votes(self) -> np.ndarray:
        return (self.lof_vote.astype(int) + self.np_vote.astype(int)
                + self.cluster_vote.astype(int))

    def anomalous(self, log_votes: Optional[np.ndarray] = None) -> np.ndarray:
        """The ensemble rule: log fires OR >= 2 metric votes."""
        metric = self.metric_votes >= 2
        if log_votes is None:
            return metric
        return np.asarray(log_votes, bool) | metric


def batch_score_windows(models: TEEModels,
                        windows: np.ndarray) -> BatchVerdicts:
    """Score (n_jobs, n_ranks, W, n_metrics) raw windows in one pass."""
    x = np.asarray(windows, np.float64)
    J, R, W, M = x.shape
    m = models.pre.apply(x.reshape(J * R, W, M), 0).reshape(J, R, W, -1)

    # LOF: per-timestep cross-rank mean/std features, all jobs at once
    feats = np.concatenate([m.mean(1), m.std(1)], axis=-1)    # (J, W, 2K)
    lof_scores = models.lof.score_batch(
        feats.reshape(J * W, -1)).reshape(J, W)
    lof_frac = np.mean(lof_scores > models.lof_thresh, axis=1)

    # NeighborProfile: per-job aggregate activity, one batched call
    agg = m[:, :, :, 0].mean(1)                               # (J, W)
    np_scores = models.nprofile.score_batch(agg)              # (J, n_sub)
    np_max = (np_scores.max(1) if np_scores.shape[1]
              else np.zeros(J))

    outlier = consistency_outlier_mask(m[:, :, :, 0])         # (J, R)
    flat = flatline_mask(x[:, :, :, 0])                       # (J, R)

    return BatchVerdicts(
        lof_frac=lof_frac, np_max=np_max,
        lof_vote=lof_frac > LOF_FRAC_VOTE,
        np_vote=np_max > models.np_thresh,
        cluster_vote=outlier.any(1),
        outlier_mask=outlier, flat_mask=flat)


def loop_score_windows(models: TEEModels,
                       windows: np.ndarray) -> BatchVerdicts:
    """The per-rank Python-loop reference: same outputs as
    :func:`batch_score_windows`, computed job by job and rank by rank.
    This is the baseline the vectorized path is gated against."""
    x = np.asarray(windows, np.float64)
    J, R, W, M = x.shape
    lof_frac = np.zeros(J)
    np_max = np.zeros(J)
    outlier = np.zeros((J, R), bool)
    flat = np.zeros((J, R), bool)
    for j in range(J):
        m = models.pre.apply(x[j], 0)
        feats = np.concatenate([m.mean(0), m.std(0)], axis=-1)
        scores = models.lof.score(feats)
        lof_frac[j] = np.mean(scores > models.lof_thresh)
        s = m[:, :, 0].mean(0)
        np_scores = models.nprofile.score(s)
        np_max[j] = float(np_scores.max()) if len(np_scores) else 0.0
        # rank-by-rank consistency: z-norm and deviation per rank
        act = m[:, :, 0]
        zs = [(act[r] - act[r].mean()) / max(act[r].std(), 1e-6)
              for r in range(R)]
        consensus = np.median(np.stack(zs), 0)
        dev = np.array([float(np.sqrt(np.mean((z - consensus) ** 2)))
                        for z in zs])
        med = np.median(dev)
        mad = np.median(np.abs(dev - med)) + 1e-9
        outlier[j] = (dev - med) / (1.4826 * mad) > 3.0
        # rank-by-rank flatline
        raw = x[j, :, :, 0]
        levels = np.array([float(raw[r].mean()) for r in range(R)])
        lmed = np.median(levels)
        for r in range(R):
            flat[j, r] = levels[r] < 0.25 * lmed and lmed >= 0.1
    return BatchVerdicts(
        lof_frac=lof_frac, np_max=np_max,
        lof_vote=lof_frac > LOF_FRAC_VOTE,
        np_vote=np_max > models.np_thresh,
        cluster_vote=outlier.any(1),
        outlier_mask=outlier, flat_mask=flat)


def to_verdicts(bv: BatchVerdicts, t0: int, t1: int,
                log_verdicts: Optional[Sequence[Optional[LogVerdict]]] = None
                ) -> List[TEEVerdict]:
    """Roll per-job batch rows into :class:`TEEVerdict`s (same vote rule
    and bad-rank ordering as ``TEEService.score_window``: first-error
    rank, then consistency outliers, then flatlined ranks)."""
    J = bv.lof_frac.shape[0]
    out: List[TEEVerdict] = []
    for j in range(J):
        lv = log_verdicts[j] if log_verdicts is not None else None
        votes = {"lof": bool(bv.lof_vote[j]),
                 "nprofile": bool(bv.np_vote[j]),
                 "cluster": bool(bv.cluster_vote[j]),
                 "log": bool(lv.anomalous) if lv is not None else False}
        metric_votes = sum(votes[k] for k in ("lof", "nprofile", "cluster"))
        anomalous = votes["log"] or metric_votes >= 2
        bad: List[int] = []
        if lv is not None and lv.first_error_rank is not None:
            bad.append(lv.first_error_rank)
        bad += [int(r) for r in np.where(bv.outlier_mask[j])[0]
                if int(r) not in bad]
        bad += [int(r) for r in np.where(bv.flat_mask[j])[0]
                if int(r) not in bad]
        detail = {"lof_frac": float(bv.lof_frac[j]),
                  "np_max": float(bv.np_max[j]),
                  "err_count": float(lv.err_count) if lv is not None else 0.0}
        out.append(TEEVerdict(bool(anomalous), votes, tuple(bad),
                              (t0, t1), detail))
    return out
