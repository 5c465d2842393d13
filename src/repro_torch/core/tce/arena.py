"""Host memory arena — the memfd/hugepage analogue.

The paper's TCE server shares checkpoint memory between processes through
Linux ``memfd`` (chosen over POSIX shm for capacity, isolation and hugepage
convenience). JAX hosts are single-process-per-worker, so the arena here is an
in-process slab allocator with the same contract: page-aligned slabs, a hard
capacity, and explicit free — giving the cache server deterministic memory
accounting (the eviction policies key off it).

Slabs are **reference counted**: delta checkpointing lets two cached steps
share one slab for an unchanged leaf (``retain``), and the slab's bytes are
charged against the capacity exactly once. ``free_slab`` drops one reference;
the memory is reclaimed when the last holder releases it — so ``used`` is
always the exact number of live slab bytes, however many entries alias them.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np

PAGE = 4096
HUGEPAGE = 2 * 1024 * 1024


def _round_up(n: int, align: int) -> int:
    return (n + align - 1) // align * align


class ArenaError(Exception):
    pass


class Arena:
    """Page-aligned slab allocator with a hard byte cap and refcounted slabs."""

    def __init__(self, capacity_bytes: int, alignment: int = PAGE):
        self.capacity = int(capacity_bytes)
        self.alignment = alignment
        self._used = 0
        self._slabs: Dict[int, np.ndarray] = {}
        self._refs: Dict[int, int] = {}
        self._next_id = 0
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        return self._used

    @property
    def free(self) -> int:
        return self.capacity - self._used

    def alloc(self, nbytes: int) -> int:
        """Allocate a slab (refcount 1); returns a slab id. Raises ArenaError
        when full."""
        size = _round_up(max(nbytes, 1), self.alignment)
        with self._lock:
            if self._used + size > self.capacity:
                raise ArenaError(
                    f"arena full: need {size}, free {self.capacity - self._used}")
            sid = self._next_id
            self._next_id += 1
            self._slabs[sid] = np.empty(size, np.uint8)
            self._refs[sid] = 1
            self._used += size
            return sid

    def retain(self, sid: int) -> int:
        """Add a reference to an existing slab (shared by a delta entry)."""
        with self._lock:
            if sid not in self._slabs:
                raise ArenaError(f"retain of unknown slab {sid}")
            self._refs[sid] += 1
            return sid

    def refcount(self, sid: int) -> int:
        return self._refs.get(sid, 0)

    def view(self, sid: int, nbytes: Optional[int] = None) -> np.ndarray:
        slab = self._slabs[sid]
        return slab[:nbytes] if nbytes is not None else slab

    def store(self, data: np.ndarray) -> int:
        """Copy `data` bytes into a fresh slab."""
        flat = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
        sid = self.alloc(flat.nbytes)
        self.view(sid, flat.nbytes)[:] = flat
        return sid

    def free_slab(self, sid: int) -> None:
        """Drop one reference; reclaim the slab when the count hits zero."""
        with self._lock:
            refs = self._refs.get(sid)
            if refs is None:
                return
            if refs > 1:
                self._refs[sid] = refs - 1
                return
            del self._refs[sid]
            slab = self._slabs.pop(sid)
            self._used -= slab.nbytes

    def clear(self) -> None:
        with self._lock:
            self._slabs.clear()
            self._refs.clear()
            self._used = 0
