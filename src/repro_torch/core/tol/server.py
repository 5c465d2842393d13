"""Transom Server — stateless lease-based leader election + bad-node registry.

The paper's design goals, kept exactly: the server holds only an in-memory
lease map; a server restart does not interrupt training because each launcher
carries its previous lease token in every request, so the restarted server
re-adopts the old lease instead of electing a new master.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set


@dataclass
class Lease:
    name: str
    holder: int
    token: int
    expires: float


class TransomServer:
    def __init__(self, lease_ttl: float = 5.0, now=time.monotonic):
        self.ttl = lease_ttl
        self.now = now
        self._leases: Dict[str, Lease] = {}
        self._bad_nodes: Set[str] = set()
        self._lock = threading.Lock()

    # -- leader election ------------------------------------------------- #
    def acquire(self, name: str, holder: int,
                prev: Optional[Lease] = None) -> Optional[Lease]:
        """Compete for lease `name`. Carrying `prev` renews after a server
        restart even though the map was wiped."""
        t = self.now()
        with self._lock:
            cur = self._leases.get(name)
            if cur is None and prev is not None and prev.holder == holder:
                # stateless-restart path: re-adopt the carried lease
                cur = Lease(name, holder, prev.token, t + self.ttl)
                self._leases[name] = cur
                return cur
            if cur is None or cur.expires <= t:
                token = (cur.token + 1) if cur else (prev.token + 1 if prev else 1)
                lease = Lease(name, holder, token, t + self.ttl)
                self._leases[name] = lease
                return lease
            if cur.holder == holder:
                cur.expires = t + self.ttl     # renew
                return cur
            return None

    def holder(self, name: str) -> Optional[int]:
        with self._lock:
            cur = self._leases.get(name)
            if cur is None or cur.expires <= self.now():
                return None
            return cur.holder

    def restart(self) -> None:
        """Simulate server downtime: all in-memory state is lost."""
        with self._lock:
            self._leases.clear()

    # -- bad-node registry (drives anti-affinity) ------------------------- #
    def report_bad_node(self, node: str) -> None:
        with self._lock:
            self._bad_nodes.add(node)

    def bad_nodes(self) -> Set[str]:
        with self._lock:
            return set(self._bad_nodes)

    def clear_bad_node(self, node: str) -> None:
        with self._lock:
            self._bad_nodes.discard(node)
