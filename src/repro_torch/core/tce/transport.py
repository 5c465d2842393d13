"""Simulated inter-node fabric for cache backup/fetch.

On the paper's cluster this is RDMA over 4x200 Gb/s IB NICs; on a TPU pod the
host-level equivalent is ICI/DCN transfers. In this container nodes are
simulated in-process: a transfer is a real memcpy plus modelled seconds on the
shared ``repro.sim`` clock (bytes / bandwidth).

Up/down state is *derived from the shared topology* when one is provided —
the fabric then has no private health model and can never disagree with the
scheduler about which rank is reachable. Without a topology (unit tests,
standalone engines) it falls back to a local injectable failure set.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Set

import numpy as np

from repro_torch.sim.clock import SimClock
from repro_torch.sim.topology import Topology

from .fastcopy import METER

RDMA_BW = 4 * 200e9 / 8   # 4 NICs x 200 Gb/s -> 100 GB/s per node
MEM_BW = 10e9             # local memory-cache write bandwidth (B_mem)


class TransportError(Exception):
    pass


class Fabric:
    """Bandwidth-modelled node-to-node transfers.

    With ``topology`` set, rank health is read from (and failures written to)
    the shared :class:`repro.sim.topology.Topology`; the private ``_down``
    set is only the topology-less fallback.
    """

    def __init__(self, bw_bytes_per_s: float = RDMA_BW,
                 clock: Optional[SimClock] = None,
                 topology: Optional[Topology] = None):
        self.bw = bw_bytes_per_s
        self.topology = topology
        if clock is None:
            clock = topology.clock if topology is not None else SimClock()
        self.clock = clock
        self._down: Set[int] = set()
        self._lock = threading.Lock()
        self.transfers = 0
        self.bytes_moved = 0

    def fail_node(self, rank: int) -> None:
        if self.topology is not None:
            self.topology.fail_rank(rank)
            return
        with self._lock:
            self._down.add(rank)

    def restore_node(self, rank: int) -> None:
        if self.topology is not None:
            self.topology.restore_rank(rank)
            return
        with self._lock:
            self._down.discard(rank)

    def is_down(self, rank: int) -> bool:
        if self.topology is not None:
            return self.topology.is_rank_down(rank)
        return rank in self._down

    def send(self, src: int, dst: int, payload: Dict[str, np.ndarray],
             check_dst: bool = True) -> Dict[str, np.ndarray]:
        """Copy payload from src to dst. Returns the received copy.

        check_dst=False models a replacement node pulling data under the old
        rank id before being marked healthy (recovery-time fetches).
        """
        if self.is_down(src):
            raise TransportError(f"source node {src} is down")
        if check_dst and self.is_down(dst):
            raise TransportError(f"destination node {dst} is down")
        nbytes = sum(np.asarray(v).nbytes for v in payload.values())
        out = {k: np.array(v, copy=True) for k, v in payload.items()}
        METER.add(nbytes)                  # the receive-side materialisation
        self.clock.advance(nbytes / self.bw)
        with self._lock:
            self.transfers += 1
            self.bytes_moved += nbytes
        return out
