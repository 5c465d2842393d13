"""Declarative final-state reconciler (the paper's C++ 'kubernetes-operator-
style' consistency mechanism).

Desired state: every cached checkpoint entry eventually has
``persisted=True`` (shards durable in the store, manifest committed) and
``backed_up=True`` (shards replicated to the ring neighbour's cache).

The reconciler never tracks in-flight work: each pass *diffs observed state
against desired state* and (re)issues whatever is missing. Failed actions
leave the flags unset, so the next pass retries them — idempotent by
construction, which is what gives crash/final-state consistency.

Datapath: one zero-copy ``cache.get`` view feeds *both* the persist and the
backup of an entry (the pre-datapath code materialised two full copies per
step per pass). With ``delta=True`` the reconciler computes per-leaf content
digests here — streaming crc32 over the arena views, *off* the training
stall path (the save stall is one parallel memcpy and nothing else) — and
only leaves whose digest changed since the rank's last persisted step hit
the store (unchanged leaves become path-compressed index refs) or cross the
fabric to the ring neighbour (the neighbour rebuilds its backup entry from
its previous one plus the changed leaves, sharing slabs for the rest).
With a non-raw ``codec`` the backup payload crosses the fabric encoded
(zlib lossless / int8 blockwise-quantised through the quant_blockwise
kernels) and is decoded on arrival. Every encode and decode of the backup
path runs on the store's ``device``, as the store's own persist does.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.sim.clock import SimClock

from .cache import CacheServer
from .codec import decode_shard, dtype_name, encode_shard, is_lossless_path
from .fastcopy import crc32_stream
from .sharding import NodeShards
from .store import DiskStore
from .transport import Fabric, TransportError


def _cuda_index(device) -> Optional[int]:
    """The CUDA device a reconciler thread must make current: the one
    ``device`` names (its index, else the starting thread's current card),
    or None when it names no card (the CPU, or None: no int8 leaf yet)."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return dev.index if dev.index is not None else torch.cuda.current_device()


class Reconciler:
    def __init__(self, caches: List[CacheServer], store: DiskStore,
                 fabric: Optional[Fabric], *, backup: bool = True,
                 interval_s: float = 0.02,
                 clock: Optional[SimClock] = None,
                 delta: bool = True, codec: str = "raw",
                 lossless_paths: Tuple[str, ...] = (),
                 legacy: bool = False, cpu_s_per_byte: float = 0.0):
        self.caches = caches
        self.store = store
        self.fabric = fabric
        self.backup = backup
        self.interval = interval_s
        self.delta = delta and not legacy
        self.codec = codec if not legacy else "raw"
        self.lossless_paths = tuple(lossless_paths)
        # where int8 leaves of the backup path are (de)quantised
        self.device = getattr(store, "device", None)
        self.legacy = legacy
        # modelled digest/encode CPU seconds per byte processed (0: free).
        # Charged only on *success* — a retried backup re-encodes for real,
        # but charging per attempt would make modelled totals depend on
        # thread timing and break report determinism.
        self.cpu_s_per_byte = cpu_s_per_byte
        # shared substrate clock: durability timestamps land on the same
        # timeline as fabric transfers and TOL recovery phases
        self.clock = clock or getattr(fabric, "clock", None) \
            or getattr(store, "clock", None) or SimClock()
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._committed: set = set()
        self._last_committed: Optional[int] = None
        # rank -> {path: (home_step, digest)} of the last persisted entry;
        # home_step is where the leaf's file actually lives (path-compressed)
        self._persisted_digests: Dict[int, Dict[str, Tuple[int, int]]] = {}
        self.durable_at: Dict[int, float] = {}   # step -> modelled seconds
        self.errors: List[str] = []
        self.passes = 0
        self.stats = {"delta_leaves_skipped": 0, "delta_leaves_written": 0,
                      "backup_leaves_sent": 0, "backup_leaves_reused": 0,
                      "backup_bytes_wire": 0, "cpu_bytes_charged": 0,
                      "cpu_s_charged": 0.0}

    # ------------------------------------------------------------------ #
    def start(self) -> None:
        if self._thread is None:
            self._stop.clear()     # restartable (scenarios pause durability)
            self._thread = threading.Thread(
                target=self._loop, args=(_cuda_index(self.device),),
                daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._kick.set()
        if self._thread is not None:
            # a bounded join can return with the loop still mid-pass on a
            # loaded host — leaving a detached thread writing into a store
            # directory the caller may be about to delete. reconcile_once
            # always terminates, so wait for the real exit.
            while self._thread.is_alive():
                self._thread.join(timeout=10)
            self._thread = None

    def kick(self) -> None:
        self._kick.set()

    def quiesce(self, timeout: float = 30.0) -> bool:
        """Block until desired state is reached (or timeout)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if not self._pending():
                return True
            self.kick()
            time.sleep(0.005)
        return False

    # ------------------------------------------------------------------ #
    def _pending(self) -> bool:
        n = len(self.caches)
        persisted: Dict[int, int] = {}
        for cache in self.caches:
            # mirror reconcile_once: a down rank's cache makes no progress,
            # so waiting on it (or counting it toward commit eligibility)
            # would spin quiesce() for its full timeout
            if self.fabric is not None and self.fabric.is_down(cache.rank):
                continue
            for step in cache.steps():
                ent = cache.entry(step)
                if ent is None or ent.is_backup:
                    continue
                if not ent.persisted or (self.backup and self.fabric is not None
                                         and len(self.caches) > 1
                                         and not ent.backed_up):
                    return True
                persisted[step] = persisted.get(step, 0) + 1
        # a step with every rank persisted is commit-eligible: durable only
        # once its manifest is written. Without this, quiesce() can return
        # between the last rank's persist and the commit at the end of the
        # same reconcile pass — and a crash in that window makes a waited-on
        # checkpoint unrecoverable.
        with self._lock:
            return any(cnt >= n and step not in self._committed
                       for step, cnt in persisted.items())

    def _loop(self, cuda_index: Optional[int] = None) -> None:
        # a thread starts on CUDA device 0: make the store's card current
        # before the first kernel of a persist or backup is launched here
        if cuda_index is not None:
            torch.cuda.set_device(cuda_index)
        while not self._stop.is_set():
            self._kick.wait(timeout=self.interval)
            self._kick.clear()
            try:
                self.reconcile_once()
            except Exception as e:  # pragma: no cover
                self.errors.append(repr(e))

    # ------------------------------------------------------------------ #
    def _charge_cpu(self, nbytes: int) -> None:
        """Charge digest/encode CPU work to the modelled clock. Off the
        training stall path by construction (the reconciler is async)."""
        if self.cpu_s_per_byte > 0 and nbytes > 0:
            self.stats["cpu_bytes_charged"] += int(nbytes)
            self.stats["cpu_s_charged"] += nbytes * self.cpu_s_per_byte
            self.clock.advance(nbytes * self.cpu_s_per_byte)

    def _digest_map(self, cache: CacheServer, step: int,
                    shards: NodeShards) -> Optional[Dict[str, int]]:
        """Per-leaf streaming crc32 over the entry's arena views — computed
        once (asynchronously, never on the save stall path), recorded on the
        entry, and reused by later passes."""
        if not self.delta:
            return None
        existing = cache.digests(step)
        if existing and all(d is not None for d, _n, _s in existing.values()):
            return {p: d for p, (d, _n, _s) in existing.items()}
        dig = {p: crc32_stream(d) for p, (sp, d) in shards.items()}
        cache.set_digests(step, dig)
        self._charge_cpu(sum(d.nbytes for _, d in shards.values()))
        return dig

    def _persist(self, cache: CacheServer, step: int, shards: NodeShards,
                 digmap: Optional[Dict[str, int]]) -> None:
        rank = cache.rank
        refs: Dict[str, Tuple[int, int]] = {}
        base = self._persisted_digests.get(rank) if self.delta else None
        if base and digmap:
            for path, digest in digmap.items():
                prev = base.get(path)
                # refs must only point *backwards*: after a rewind-and-replay
                # a re-persisted step could otherwise ref a later step whose
                # own chain points back at it (a delta-ref cycle on disk)
                if prev is not None and prev[1] == digest and prev[0] < step:
                    refs[path] = prev            # (home_step, digest)
        self.store.write_rank(step, rank, shards, refs=refs, digests=digmap,
                              codec=self.codec,
                              lossless_paths=self.lossless_paths)
        if self.codec != "raw":
            self._charge_cpu(sum(d.nbytes for p, (_sp, d) in shards.items()
                                 if p not in refs))
        self.stats["delta_leaves_skipped"] += len(refs)
        self.stats["delta_leaves_written"] += len(shards) - len(refs)
        if self.delta and digmap:
            self._persisted_digests[rank] = {
                path: (refs[path] if path in refs else (step, digest))
                for path, digest in digmap.items()}
        cache.mark(step, persisted=True)

    def _backup(self, cache: CacheServer, step: int, shards: NodeShards,
                digmap: Optional[Dict[str, int]]) -> None:
        n = len(self.caches)
        rank = cache.rank
        dst = (rank + 1) % n
        dst_cache = self.caches[dst]
        base_step = None
        changed = set(shards)
        if digmap is not None:
            base_step = dst_cache.latest_step_for(rank, before_step=step)
            prev = (dst_cache.digests(base_step, owner_rank=rank)
                    if base_step is not None else None)
            # a leaf dropped from the state must not be resurrected from the
            # base entry (put_delta carries every base leaf over) — schema
            # changes fall back to a full send
            if prev and set(prev) <= set(shards):
                changed = {p for p in shards
                           if p not in digmap or p not in prev
                           or prev[p][0] != digmap[p]
                           or prev[p][2] != shards[p][0]}
            else:
                base_step = None
        wire: Dict = {}
        metas: Dict[str, tuple] = {}
        for path in changed:
            spec, data = shards[path]
            enc, payload, meta = encode_shard(
                data, self.codec,
                lossless=is_lossless_path(path, self.lossless_paths),
                device=self.device)
            wire[path] = payload
            metas[path] = (enc, meta, dtype_name(data.dtype), tuple(data.shape))
        self.fabric.send(rank, dst, wire)
        self.stats["backup_bytes_wire"] += sum(p.nbytes for p in wire.values())
        decoded: NodeShards = {
            path: (shards[path][0],
                   decode_shard(metas[path][0], wire[path], metas[path][2],
                                metas[path][3], metas[path][1],
                                device=self.device))
            for path in changed}
        sent, reused = len(changed), len(shards) - len(changed)
        if base_step is not None and len(changed) < len(shards):
            try:
                dst_cache.put_delta(step, decoded, base_step,
                                    owner_rank=rank, is_backup=True,
                                    digests=digmap)
                if self.codec != "raw":
                    self._charge_cpu(sum(d.nbytes
                                         for _sp, d in decoded.values()))
                self.stats["backup_leaves_sent"] += sent
                self.stats["backup_leaves_reused"] += reused
                cache.mark(step, backed_up=True)
                return
            except KeyError:
                # base evicted between digest query and put: fall through to
                # a full re-send (idempotent; flags stay unset on failure)
                missing = {p: shards[p] for p in shards if p not in changed}
                for path, (spec, data) in missing.items():
                    enc, payload, meta = encode_shard(
                        data, self.codec,
                        lossless=is_lossless_path(path, self.lossless_paths),
                        device=self.device)
                    wire[path] = payload
                    decoded[path] = (spec, decode_shard(
                        enc, payload, dtype_name(data.dtype), tuple(data.shape),
                        meta, device=self.device))
                self.fabric.send(rank, dst,
                                 {p: wire[p] for p in missing})
                self.stats["backup_bytes_wire"] += sum(
                    wire[p].nbytes for p in missing)
                sent, reused = len(shards), 0
        dst_cache.put(step, decoded, is_backup=True, owner_rank=rank,
                      digests=digmap)
        if self.codec != "raw":
            self._charge_cpu(sum(d.nbytes for _sp, d in decoded.values()))
        self.stats["backup_leaves_sent"] += sent
        self.stats["backup_leaves_reused"] += reused
        cache.mark(step, backed_up=True)

    def _backup_legacy(self, cache: CacheServer, step: int) -> None:
        """Pre-datapath behaviour: second full cache.get + raw full send."""
        dst = (cache.rank + 1) % len(self.caches)
        shards = cache.get(step)
        payload = {p: d for p, (sp, d) in shards.items()}
        self.fabric.send(cache.rank, dst, payload)
        self.caches[dst].put(step, shards, is_backup=True,
                             owner_rank=cache.rank)
        cache.mark(step, backed_up=True)

    def reconcile_once(self) -> None:
        self.passes += 1
        n = len(self.caches)
        persisted_steps: Dict[int, int] = {}
        for cache in self.caches:
            if self.fabric is not None and self.fabric.is_down(cache.rank):
                continue
            for step in cache.steps():
                ent = cache.entry(step)
                if ent is None or ent.is_backup:
                    continue
                want_backup = (self.backup and self.fabric is not None
                               and n > 1 and not ent.backed_up)
                shards: Optional[NodeShards] = None
                digmap: Optional[Dict[str, int]] = None
                if not ent.persisted or want_backup:
                    # one zero-copy view (and one digest pass) feeds both the
                    # persist and the backup
                    shards = cache.get(step)
                    if shards is not None and not self.legacy:
                        digmap = self._digest_map(cache, step, shards)
                if not ent.persisted and shards is not None:
                    try:
                        self._persist(cache, step, shards, digmap)
                    except Exception as e:
                        self.errors.append(f"persist r{cache.rank} s{step}: {e!r}")
                if want_backup and shards is not None:
                    try:
                        if self.legacy:
                            self._backup_legacy(cache, step)
                        else:
                            self._backup(cache, step, shards, digmap)
                    except TransportError as e:
                        self.errors.append(f"backup r{cache.rank} s{step}: {e!r}")
                ent = cache.entry(step)
                if ent is not None and ent.persisted:
                    persisted_steps[step] = persisted_steps.get(step, 0) + 1
        # commit manifests for fully-persisted steps (idempotent)
        with self._lock:
            for step, cnt in sorted(persisted_steps.items()):
                if cnt >= n and step not in self._committed:
                    self.store.commit(step, n,
                                      delta_base=self._last_committed
                                      if self.delta else None)
                    self._committed.add(step)
                    self._last_committed = step
                    self.durable_at[step] = self.clock.seconds
        # tier-aware aging: a TieredStore demotes steps over a leg's
        # capacity budget one rung down the hierarchy (idempotent no-op on
        # plain stores and under-budget legs)
        demote = getattr(self.store, "demote_due", None)
        if demote is not None:
            try:
                demote()
            except Exception as e:
                self.errors.append(f"demote: {e!r}")
