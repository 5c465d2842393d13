"""Warm-up and error-check task suites (paper §IV-A task types 1 & 3).

Counterpart of ``repro.core.tol.tasks``. Warm-up runs before every
(re)start; error-check runs when the master is notified of an anomaly. Both
are *real* checks against the local torch runtime on an explicit ``device``
(device burn-in = small float32 matmul vs numpy oracle; collective check =
a sum across the local CUDA devices vs the analytic value), plus simulated
per-node checks against the ClusterSim (disk, link) so tests can inject
failures.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device

from .cluster import ClusterSim, NodeState


@dataclass
class TaskResult:
    name: str
    ok: bool
    detail: str = ""
    bad_nodes: List[str] = field(default_factory=list)
    elapsed_s: float = 0.0


def _timed(fn):
    def wrap(*a, **k) -> TaskResult:
        t0 = time.perf_counter()
        r = fn(*a, **k)
        r.elapsed_s = time.perf_counter() - t0
        return r
    return wrap


# --------------------------------------------------------------------------- #
# Real local-runtime checks
# --------------------------------------------------------------------------- #
@_timed
def disk_check(paths: List[str]) -> TaskResult:
    """Datasets/code mounted and readable."""
    missing = [p for p in paths if not os.path.exists(p)]
    return TaskResult("disk_check", not missing,
                      f"missing: {missing}" if missing else "all paths ok")


@_timed
def device_burn_in(device, size: int = 256, iters: int = 2) -> TaskResult:
    """Small float32 matmul on ``device``, checked against a numpy oracle.

    TF32 is held off for the check: a TF32 product of ``size`` terms can miss
    the 1e-3 tolerance on a healthy card."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((size, size), np.float32)
    b = rng.standard_normal((size, size), np.float32)
    want = a @ b
    bad = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x, y = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        for _ in range(iters):
            got = torch.matmul(x, y).cpu().numpy()
            if not np.allclose(got, want, rtol=1e-3, atol=1e-3):
                bad.append(str(dev))
                break
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return TaskResult("device_burn_in", not bad,
                      f"bad devices: {bad}" if bad else f"{dev} ok", bad)


@_timed
def collective_check(device) -> TaskResult:
    """Sum across all local CUDA devices vs the analytic value (NCCL-test
    analogue; in-process, as the reference's ``pmap`` psum)."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n == 1:
        x = torch.ones(8, device=dev)
        ok = bool(torch.allclose(x.sum(), torch.tensor(8.0, device=dev)))
        return TaskResult("collective_check", ok, "single-device trivial pass")
    out = torch.cuda.comm.reduce_add(
        [torch.ones(8, device=torch.device("cuda", i)) for i in range(n)],
        destination=dev.index or 0)
    ok = bool(np.allclose(out.cpu().numpy(), n))
    return TaskResult("collective_check", ok, f"sum over {n} devices")


# --------------------------------------------------------------------------- #
# Simulated per-node checks (ClusterSim-aware)
# --------------------------------------------------------------------------- #
@_timed
def node_health_check(cluster: ClusterSim) -> TaskResult:
    bad = cluster.bad_assigned_nodes()
    return TaskResult("node_health_check", not bad,
                      f"bad: {bad}" if bad else "all assigned nodes healthy", bad)


@_timed
def connectivity_check(cluster: ClusterSim) -> TaskResult:
    bad = [n for n in cluster.assigned
           if cluster.nodes[n].state == NodeState.DEGRADED
           and cluster.nodes[n].fail_category == "network"]
    return TaskResult("connectivity_check", not bad,
                      f"link issues: {bad}" if bad else "fabric ok", bad)


# --------------------------------------------------------------------------- #
def warmup_tasks(cluster: Optional[ClusterSim] = None,
                 data_paths: Optional[List[str]] = None, *,
                 device) -> List[TaskResult]:
    out = [disk_check(data_paths or ["."]), device_burn_in(device),
           collective_check(device)]
    if cluster is not None:
        out += [node_health_check(cluster), connectivity_check(cluster)]
    return out


def error_check_tasks(cluster: Optional[ClusterSim] = None,
                      tee_bad_ranks: Optional[List[int]] = None,
                      rank_to_node: Optional[Dict[int, str]] = None, *,
                      device) -> List[TaskResult]:
    out = [disk_check(["."]), device_burn_in(device), collective_check(device)]
    if cluster is not None:
        out += [node_health_check(cluster), connectivity_check(cluster)]
    if tee_bad_ranks and rank_to_node:
        nodes = sorted({rank_to_node[r] for r in tee_bad_ranks
                        if r in rank_to_node})
        out.append(TaskResult("tee_attribution", not nodes,
                              f"TEE flags: {nodes}", nodes))
    return out
