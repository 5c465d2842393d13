"""Per-node checkpoint cache server.

One ``CacheServer`` per (simulated) node. Holds checkpoint shards for recent
steps in the arena, enforces the paper's two eviction strategies (memory cap ->
evict oldest; max cached cycles), and tracks which steps have been persisted /
backed up (the reconciler drives those flags to the desired state).

Datapath contract (zero-copy staging):

* ``put`` moves each leaf's bytes exactly **once** — a direct chunked
  multi-threaded copy straight into a fresh arena slab. Nothing else happens
  on the training-stall path: no hashing, no comparing (change detection is
  the *async* reconciler's job, over zero-copy views of these slabs).
* ``get`` returns **read-only views** into the arena — no copy. Consumers
  that need to mutate (none on the hot path) must copy explicitly. Slabs
  are immutable once staged, so a leaf's content digest, computed once by
  the reconciler, stays valid for the entry's lifetime.
* ``put_delta`` builds an entry from a base entry plus only the changed
  leaves — unchanged leaves *share* the base entry's slabs (refcounted, so
  arena accounting stays exact). This is the ring-backup receive path:
  unchanged leaves never cross the fabric twice and are cached once.
  ``digests`` carries the *source* cache's content digests through, so
  cross-cache delta comparisons stay consistent even when the payload was
  lossy-decoded (int8 codec).

``legacy=True`` restores the pre-datapath behaviour (bounce-buffer staging,
copying ``get``) for A/B benchmarking.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .arena import Arena, ArenaError
from .codec import dtype_name, np_dtype
from .fastcopy import METER, chunked_copy
from .sharding import NodeShards, ShardSpec


@dataclass(frozen=True)
class EvictionConfig:
    mem_limit_bytes: int = 1 << 30
    max_cycles: int = 2              # max checkpoint steps kept in cache


@dataclass(frozen=True)
class StoredShard:
    spec: ShardSpec
    sid: int                         # arena slab id (possibly shared)
    nbytes: int
    dtype: str
    shape: Tuple[int, ...]
    digest: Optional[int]            # content digest (filled by the reconciler
                                     # or passed through on backup receives)


@dataclass
class CacheEntry:
    step: int
    shards: Dict[str, StoredShard]
    persisted: bool = False
    backed_up: bool = False
    is_backup: bool = False                       # True when held for a neighbour
    owner_rank: int = -1


@dataclass(frozen=True)
class PutStats:
    nbytes: int          # logical bytes in the entry
    bytes_staged: int    # logical bytes that had to reach the arena (copied once)
    reused_leaves: int   # leaves shared with the previous entry (no copy)


class CacheServer:
    def __init__(self, rank: int, evict: EvictionConfig = EvictionConfig(),
                 *, copy_mode: str = "direct", legacy: bool = False):
        self.rank = rank
        self.evict_cfg = evict
        self.arena = Arena(evict.mem_limit_bytes)
        self.copy_mode = "bounce" if legacy else copy_mode
        self.legacy = legacy
        self._entries: Dict[tuple, CacheEntry] = {}   # (step, owner) -> entry
        self._lock = threading.RLock()
        self.evictions = 0

    # ------------------------------------------------------------------ #
    def _latest_key(self, owner: int, before_step: Optional[int] = None
                    ) -> Optional[tuple]:
        cands = [s for (s, o) in self._entries
                 if o == owner and (before_step is None or s != before_step)]
        return (max(cands), owner) if cands else None

    def _stage(self, data: np.ndarray, n_threads: int) -> Tuple[int, int]:
        """Copy one leaf's bytes into a fresh slab. Returns (sid, staged)."""
        flat = data.view(np.uint8).reshape(-1)
        sid = self._alloc_with_eviction(flat.nbytes)
        chunked_copy(self.arena.view(sid, flat.nbytes), flat,
                     n_threads=n_threads, mode=self.copy_mode)
        return sid, flat.nbytes

    def put(self, step: int, shards: NodeShards, *, is_backup: bool = False,
            owner_rank: Optional[int] = None, n_threads: int = 2,
            digests: Optional[Dict[str, int]] = None) -> PutStats:
        """Stage a full shard map: one direct copy per leaf, nothing else.
        ``digests`` passes content digests through (ring-backup receives use
        the *source* digests so cross-cache delta comparisons stay consistent
        for lossy-decoded payloads; own saves leave them for the async
        reconciler to fill via :meth:`set_digests`)."""
        owner = self.rank if owner_rank is None else owner_rank
        stored: Dict[str, StoredShard] = {}
        nbytes = staged = 0
        with self._lock:
            try:
                for path, (spec, data) in shards.items():
                    contig = np.ascontiguousarray(data)
                    if contig is not data and contig.base is not data:
                        METER.add(contig.nbytes)     # forced contiguity copy
                    data = contig
                    nbytes += data.nbytes
                    digest = digests.get(path) if digests else None
                    sid, n = self._stage(data, n_threads)
                    staged += n
                    stored[path] = StoredShard(spec, sid, n, dtype_name(data.dtype),
                                               tuple(data.shape), digest)
            except ArenaError:
                for ss in stored.values():   # no leaked slabs on failure
                    self.arena.free_slab(ss.sid)
                raise
            key = (step, owner)
            if key in self._entries:
                self._drop(key)
            self._entries[key] = CacheEntry(step, stored, is_backup=is_backup,
                                            owner_rank=owner)
            self._enforce_cycles()
        return PutStats(nbytes, staged, 0)

    def set_digests(self, step: int, digests: Dict[str, int],
                    owner_rank: Optional[int] = None) -> None:
        """Record per-leaf content digests on an entry (reconciler-computed;
        slabs are immutable after staging, so digests stay valid)."""
        owner = self.rank if owner_rank is None else owner_rank
        with self._lock:
            ent = self._entries.get((step, owner))
            if ent is None:
                return
            for path, ss in list(ent.shards.items()):
                d = digests.get(path)
                if d is not None and ss.digest is None:
                    ent.shards[path] = StoredShard(ss.spec, ss.sid, ss.nbytes,
                                                   ss.dtype, ss.shape, int(d))

    def put_delta(self, step: int, changed: NodeShards, base_step: int, *,
                  owner_rank: Optional[int] = None, is_backup: bool = True,
                  n_threads: int = 2,
                  digests: Optional[Dict[str, int]] = None) -> PutStats:
        """Build an entry from ``base_step``'s entry plus only the changed
        leaves. Raises KeyError when the base entry is gone (caller falls
        back to a full put)."""
        owner = self.rank if owner_rank is None else owner_rank
        nbytes = staged = reused = 0
        with self._lock:
            base = self._entries.get((base_step, owner))
            if base is None:
                raise KeyError(f"delta base step {base_step} for owner "
                               f"{owner} not cached on rank {self.rank}")
            stored: Dict[str, StoredShard] = {}
            try:
                for path, ss in base.shards.items():
                    if path in changed:
                        continue
                    self.arena.retain(ss.sid)
                    stored[path] = ss
                    nbytes += ss.nbytes
                    reused += 1
                for path, (spec, data) in changed.items():
                    data = np.ascontiguousarray(data)
                    digest = digests.get(path) if digests else None
                    sid, n = self._stage(data, n_threads)
                    nbytes += n
                    staged += n
                    stored[path] = StoredShard(spec, sid, n, dtype_name(data.dtype),
                                               tuple(data.shape), digest)
            except ArenaError:
                # roll back references/slabs taken so far — a failed delta
                # put must not leak arena capacity
                for ss in stored.values():
                    self.arena.free_slab(ss.sid)
                raise
            key = (step, owner)
            if key in self._entries:
                self._drop(key)
            self._entries[key] = CacheEntry(step, stored, is_backup=is_backup,
                                            owner_rank=owner)
            self._enforce_cycles()
        return PutStats(nbytes, staged, reused)

    def get(self, step: int, owner_rank: Optional[int] = None
            ) -> Optional[NodeShards]:
        """Zero-copy read: the returned arrays are read-only views into the
        arena (legacy mode returns materialised copies, pre-datapath style)."""
        owner = self.rank if owner_rank is None else owner_rank
        with self._lock:
            ent = self._entries.get((step, owner))
            if ent is None:
                return None
            out: NodeShards = {}
            for path, ss in ent.shards.items():
                buf = self.arena.view(ss.sid, ss.nbytes)
                if self.legacy:
                    arr = np.array(buf.view(np_dtype(ss.dtype))).reshape(ss.shape)
                    METER.add(ss.nbytes)
                else:
                    arr = buf.view(np_dtype(ss.dtype)).reshape(ss.shape)
                    arr.flags.writeable = False
                out[path] = (ss.spec, arr)
            return out

    def digests(self, step: int, owner_rank: Optional[int] = None
                ) -> Optional[Dict[str, tuple]]:
        """{path: (token, nbytes, spec)} for one entry, or None."""
        owner = self.rank if owner_rank is None else owner_rank
        with self._lock:
            ent = self._entries.get((step, owner))
            if ent is None:
                return None
            return {p: (ss.digest, ss.nbytes, ss.spec)
                    for p, ss in ent.shards.items()}

    def latest_step_for(self, owner_rank: int, *,
                        before_step: Optional[int] = None) -> Optional[int]:
        with self._lock:
            key = self._latest_key(owner_rank, before_step=before_step)
            return key[0] if key else None

    # ------------------------------------------------------------------ #
    def steps(self, include_backups: bool = False) -> List[int]:
        with self._lock:
            return sorted({s for (s, o), e in self._entries.items()
                           if include_backups or not e.is_backup})

    def entry(self, step: int, owner_rank: Optional[int] = None
              ) -> Optional[CacheEntry]:
        owner = self.rank if owner_rank is None else owner_rank
        return self._entries.get((step, owner))

    def mark(self, step: int, *, persisted: Optional[bool] = None,
             backed_up: Optional[bool] = None,
             owner_rank: Optional[int] = None) -> None:
        ent = self.entry(step, owner_rank)
        if ent is None:
            return
        if persisted is not None:
            ent.persisted = persisted
        if backed_up is not None:
            ent.backed_up = backed_up

    def wipe(self) -> None:
        """Simulated node crash: all cached checkpoints are lost."""
        with self._lock:
            self._entries.clear()
            self.arena.clear()

    # -- eviction -------------------------------------------------------- #
    def _alloc_with_eviction(self, nbytes: int) -> int:
        while True:
            try:
                return self.arena.alloc(nbytes)
            except ArenaError:
                if not self._evict_oldest():
                    raise

    def _evict_oldest(self) -> bool:
        # oldest (lowest step) first; prefer non-backup owner entries? The
        # paper evicts oldest caches under memory pressure — we follow that,
        # backups included (they are re-creatable from their owner).
        if not self._entries:
            return False
        key = min(self._entries, key=lambda k: k[0])
        self._drop(key)
        self.evictions += 1
        return True

    def _enforce_cycles(self) -> None:
        own_steps = sorted({s for (s, o) in self._entries if o == self.rank})
        while len(own_steps) > self.evict_cfg.max_cycles:
            s = own_steps.pop(0)
            self._drop((s, self.rank))
            self.evictions += 1

    def _drop(self, key: tuple) -> None:
        ent = self._entries.pop(key, None)
        if ent is None:
            return
        for path, ss in ent.shards.items():
            self.arena.free_slab(ss.sid)
