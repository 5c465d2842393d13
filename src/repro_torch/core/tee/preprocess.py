"""Data preprocessing for TEE (paper §V-B).

Three production problems and their fixes:
  1. metric selection      — drop near-constant metrics and near-duplicate
                             (|corr| > 0.98) pairs, keep training-relevant ones
  2. useless init phase    — trim the annotated initialization prefix
  3. fast 0/1 flapping     — IB/NVLink counters alias the fwd/bwd cadence
                             (Nyquist); median-filter to smooth
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np


def median_filter(x: np.ndarray, width: int = 5) -> np.ndarray:
    """Median filter along the last axis."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.concatenate([x[..., :1].repeat(pad, -1), x,
                         x[..., -1:].repeat(pad, -1)], -1)
    win = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(win, axis=-1)


@dataclass
class Preprocessor:
    median_width: int = 5
    min_std: float = 0.01
    dup_corr: float = 0.98
    keep: Optional[List[int]] = None          # selected metric indices
    mu: Optional[np.ndarray] = None
    sd: Optional[np.ndarray] = None

    def fit(self, traces_metrics: List[np.ndarray],
            init_lens: Optional[List[int]] = None) -> "Preprocessor":
        """traces_metrics: list of (n_ranks, T, n_metrics) normal traces."""
        init_lens = init_lens or [0] * len(traces_metrics)
        flat = np.concatenate(
            [m[:, il:, :].reshape(-1, m.shape[-1])
             for m, il in zip(traces_metrics, init_lens)], 0)
        std = flat.std(0)
        keep = [i for i in range(flat.shape[1]) if std[i] >= self.min_std]
        # drop near-duplicates (strong linear correlation)
        if len(keep) > 1:
            c = np.corrcoef(flat[:, keep].T)
            final = []
            for a, i in enumerate(keep):
                if all(abs(c[a, b]) < self.dup_corr for b in range(a)
                       if keep[b] in final):
                    final.append(i)
            keep = final or keep[:1]
        self.keep = keep
        self.mu = flat[:, keep].mean(0)
        self.sd = np.maximum(flat[:, keep].std(0), 1e-6)
        return self

    def apply(self, metrics: np.ndarray, init_len: int = 0) -> np.ndarray:
        """(n_ranks, T, n_metrics) -> filtered, selected, z-normed (trim init)."""
        assert self.keep is not None, "call fit() first"
        m = metrics[:, init_len:, self.keep]
        m = np.moveaxis(median_filter(np.moveaxis(m, 1, -1),
                                      self.median_width), -1, 1)
        return (m - self.mu) / self.sd
