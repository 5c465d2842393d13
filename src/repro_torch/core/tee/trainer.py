"""TEE offline training subsystem + versioned model registry.

Fits the detector ensemble on *normal* traces, derives alarm thresholds from
held-out normal windows, evaluates candidate versions on a labelled test set
(accuracy/precision/recall), and only registers versions that pass the gate —
failing versions are discarded, matching the paper's iteration loop.
"""
from __future__ import annotations

import json
import pickle
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .detectors import LOF, NeighborProfile
from .preprocess import Preprocessor
from .traces import TaskTrace


@dataclass
class TEEModels:
    pre: Preprocessor
    lof: LOF
    nprofile: NeighborProfile
    lof_thresh: float
    np_thresh: float
    window: int
    meta: dict = field(default_factory=dict)


def _window_features(m: np.ndarray) -> np.ndarray:
    """(n_ranks, W, n_metrics) -> per-timestep feature vectors (W, 2*n_metrics):
    cross-rank mean and std of each metric (rank consistency prior)."""
    return np.concatenate([m.mean(0), m.std(0)], axis=-1)


def _agg_series(m: np.ndarray) -> np.ndarray:
    """(n_ranks, W, n_metrics) -> 1-D activity series (periodicity prior)."""
    return m[:, :, 0].mean(0)


class OfflineTrainer:
    def __init__(self, window: int = 80, lof_k: int = 12,
                 np_m: int = 40, np_k: int = 5):
        self.window = window
        self.lof_k = lof_k
        self.np_m = np_m
        self.np_k = np_k

    # ------------------------------------------------------------------ #
    def fit(self, normal: List[TaskTrace]) -> TEEModels:
        assert normal, "need normal traces"
        pre = Preprocessor().fit([t.metrics for t in normal],
                                 [t.init_len for t in normal])
        feats, series = [], []
        for t in normal:
            m = pre.apply(t.metrics, t.init_len)
            feats.append(_window_features(m))
            series.append(_agg_series(m))
        lof = LOF(self.lof_k).fit(np.concatenate(feats, 0))
        nprof = NeighborProfile(self.np_m, self.np_k).fit(series)

        # thresholds: high quantile of scores on the (normal) training windows
        lof_scores = np.concatenate([lof.score(f) for f in feats])
        np_scores = np.concatenate([nprof.score(s) for s in series])
        lof_thresh = float(np.quantile(lof_scores, 0.995) * 1.25)
        np_thresh = float(np.quantile(np_scores, 0.995) * 1.25)
        return TEEModels(pre, lof, nprof, lof_thresh, np_thresh, self.window,
                         meta={"n_normal": len(normal),
                               "fit_time": time.time()})

    # ------------------------------------------------------------------ #
    def evaluate(self, models: TEEModels, labeled: List[TaskTrace]
                 ) -> Dict[str, float]:
        """Task-level evaluation: predict anomalous iff any window fires."""
        from .service import TEEService
        svc = TEEService(models)
        tp = fp = tn = fn = 0
        for t in labeled:
            pred = svc.detect_task(t).anomalous
            actual = t.label is not None
            tp += pred and actual
            fp += pred and not actual
            tn += (not pred) and (not actual)
            fn += (not pred) and actual
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        acc = (tp + tn) / max(len(labeled), 1)
        return {"accuracy": acc, "precision": prec, "recall": rec,
                "tp": tp, "fp": fp, "tn": tn, "fn": fn}


class ModelRegistry:
    """Versioned storage with a test-gate: versions that fail are discarded."""

    def __init__(self, root: str, min_recall: float = 0.9,
                 min_precision: float = 0.8):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.min_recall = min_recall
        self.min_precision = min_precision

    def register(self, models: TEEModels, metrics: Dict[str, float]
                 ) -> Optional[int]:
        """Returns the version id, or None when the gate rejects it."""
        if metrics.get("recall", 0) < self.min_recall or \
           metrics.get("precision", 0) < self.min_precision:
            return None
        version = (self.latest_version() or 0) + 1
        d = self.root / f"v{version:04d}"
        d.mkdir()
        with open(d / "models.pkl", "wb") as f:
            pickle.dump(models, f)
        (d / "metrics.json").write_text(json.dumps(metrics))
        return version

    def latest_version(self) -> Optional[int]:
        vs = sorted(int(p.name[1:]) for p in self.root.glob("v????"))
        return vs[-1] if vs else None

    def load(self, version: Optional[int] = None) -> TEEModels:
        version = version or self.latest_version()
        if version is None:
            raise FileNotFoundError("no registered TEE model version")
        with open(self.root / f"v{version:04d}" / "models.pkl", "rb") as f:
            return pickle.load(f)
