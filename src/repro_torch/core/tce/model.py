"""Analytic performance model — paper §IV-C eqs. (1)–(3).

For a P-parameter model on N nodes (8 ranks/node) trained with ZeRO +
fp16/bf16 weights and fp32 Adam state:

  (1) max save per rank:  max(S_save) = 2P/(8N/DP) + 12P/(8N) = (DP+6)P/(4N)
  (2) save gain:          G_save = B_mem / B_nas
  (3) TCE load latency:   T_load = (DP+6)P/(4N B_mem)                 DP <= 8
                                 = 3P/(2N B_mem)
                                   + (DP-8) DP P/(32N B_rdma)         DP >  8
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TheoryParams:
    p: float                       # parameter count
    n_nodes: int                   # N (8 GPUs per node)
    dp: int                        # data-parallel size
    b_mem: float = 10e9            # local memory-cache bandwidth (B/s)
    b_nas: float = 71.1e6          # NAS bandwidth per rank (B/s) — paper
    b_rdma: float = 100e9          # per-node RDMA bandwidth (B/s)


def max_save_bytes_per_rank(t: TheoryParams) -> float:
    """Eq. (1): weights 2P over (8N/DP) ranks + optimizer 12P over 8N ranks."""
    return (t.dp + 6) * t.p / (4 * t.n_nodes)


def mean_save_bytes_per_rank(t: TheoryParams) -> float:
    """Mean across ranks: total ckpt (2+12)P spread over 8N ranks — this is
    the quantity behind the paper's '175B in ~4.5 min at ~71.1 MB/s/rank'
    estimate (2.3 TB / 128 ranks ~ 18 GB)."""
    return 14 * t.p / (8 * t.n_nodes)


def save_gain(t: TheoryParams) -> float:
    """Eq. (2)."""
    return t.b_mem / t.b_nas


def t_save_nas(t: TheoryParams) -> float:
    return max_save_bytes_per_rank(t) / t.b_nas


def t_save_tce(t: TheoryParams) -> float:
    return max_save_bytes_per_rank(t) / t.b_mem


def t_load_tce(t: TheoryParams) -> float:
    """Eq. (3)."""
    if t.dp <= 8:
        return (t.dp + 6) * t.p / (4 * t.n_nodes * t.b_mem)
    return (3 * t.p / (2 * t.n_nodes * t.b_mem)
            + (t.dp - 8) * t.dp * t.p / (32 * t.n_nodes * t.b_rdma))


def t_load_nas(t: TheoryParams) -> float:
    return max_save_bytes_per_rank(t) / t.b_nas


def tce_theory(t: TheoryParams) -> dict:
    mean = mean_save_bytes_per_rank(t)
    return {
        "max_save_bytes_per_rank": max_save_bytes_per_rank(t),
        "mean_save_bytes_per_rank": mean,
        "G_save": save_gain(t),
        "t_save_nas_s": t_save_nas(t),
        "t_save_nas_mean_s": mean / t.b_nas,
        "t_save_tce_s": t_save_tce(t),
        "t_save_tce_mean_s": mean / t.b_mem,
        "t_load_nas_s": t_load_nas(t),
        "t_load_tce_s": t_load_tce(t),
        "load_speedup": t_load_nas(t) / max(t_load_tce(t), 1e-12),
    }
