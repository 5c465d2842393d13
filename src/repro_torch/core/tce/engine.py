"""TCE — Transom Checkpoint Engine.

Save path (paper §IV-C):
  1. snapshot train-state leaves to host memory into per-node cache servers
     -> training resumes. Zero-copy staging: shard views are copied ONCE,
     chunked + multi-threaded, straight into pre-allocated arena slabs, and
     all node caches are written in parallel on a thread pool (the wall
     clock now matches the "nodes write in parallel" model that
     ``modeled_cache_s`` always claimed). Nothing else runs on the stall
     path — no checksums, no hashing, no bounce buffers.
  2. asynchronously: reconciler digests the staged slabs (streaming crc32
     over zero-copy views), persists every rank's shards to the store and
     ring-backs-up each cache to node (rank+1) % n — delta-aware (only
     leaves whose digest changed move; the neighbour shares slabs for the
     rest) and optionally compressed (zlib / int8 blockwise quantisation
     through the quant_blockwise kernels, on the store's device)
                                                         -> zero training stall

Load path (waterfall, with request dedup):
  local cache -> ring neighbour's backup (one fabric fetch per node, however
  many local consumers ask) -> persistent store (delta chains resolved
  transparently). Per-rank cache/backup fetches run on the thread pool;
  store reads stay serial (the NAS is the modelled shared bottleneck). A
  checkpoint written on N nodes restores onto M != N nodes via resharding
  (elastic, beyond-paper).

Counterpart of ``repro.core.tce.engine``. The port's trees are NamedTuples
(``TrainState``), dicts, lists and tuples of tensors: :func:`flatten_pytree`
takes one to ``{path: ndarray}`` with the reference's path strings (NamedTuple
fields by name, dict keys sorted, sequence items by index, joined with ``/``:
``step``, ``params/segments/stack/l0/mix/wq``, ``opt/m/tok/table/q``), so a
checkpoint written by either package restores in the other. Every leaf is a
host copy of its own: a card's tensor is copied to the host once, and a CPU
tensor is cloned, since the optimizer updates the state in place and a
flat dict that aliased it (a cached save, the device-tier snapshot) would
drift with it. numpy has no bfloat16, so a bf16 tensor flattens to its bit
pattern in the codec's :data:`~repro_torch.core.tce.codec.BF16` carrier and
comes back bit for bit. :func:`unflatten_like` gives each leaf the
template's dtype, shape and device.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.recovery.tiers import (TIER_DEVICE, TIER_DRAM, TIER_NAS,
                                        TIER_PEER, TierTable)
from repro_torch.sim.clock import SimClock
from repro_torch.sim.topology import Topology

from .cache import CacheServer, EvictionConfig, PutStats
from .codec import BF16
from .fastcopy import METER, snapshot
from .reconciler import Reconciler
from .sharding import NodeShards, shard_state, unshard_state
from .store import DiskStore, NAS_BW_PER_RANK
from .transport import Fabric, MEM_BW, TransportError


# --------------------------------------------------------------------------- #
# Pytree <-> flat dict
# --------------------------------------------------------------------------- #
def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if _is_namedtuple(tree):
        kids = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), x) for i, x in enumerate(tree)]
    else:
        yield (prefix or "leaf"), tree
        return
    for key, sub in kids:
        yield from _items(sub, f"{prefix}/{key}" if prefix else key)


def flatten_pytree(tree) -> Dict[str, np.ndarray]:
    """Flatten a tree of tensors to {path: np.ndarray}, each leaf a host
    copy that no later in-place update of the tree reaches (a CPU tensor is
    cloned: ``.cpu()`` would hand back the live tensor)."""
    return {path: snapshot(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            for path, leaf in _items(tree)}


def _like(leaf, arr: np.ndarray):
    if not isinstance(leaf, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype == BF16:
        t = torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    t = t.to(leaf.dtype)
    return t.reshape(leaf.shape).to(leaf.device)


def _rebuild(tree, flat: Dict[str, np.ndarray], prefix: str = ""):
    def path(key):
        return f"{prefix}/{key}" if prefix else key

    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), flat, path(f)) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, path(str(k))) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, flat, path(str(i))) for i, x in enumerate(tree))
    return _like(tree, flat[prefix or "leaf"])


def unflatten_like(tree, flat: Dict[str, np.ndarray]):
    """Inverse of flatten_pytree given a template tree: each leaf takes the
    template's dtype, shape and device."""
    return _rebuild(tree, flat)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class TCEConfig:
    n_nodes: int = 4
    mem_limit_bytes: int = 1 << 30
    max_cycles: int = 2
    backup: bool = True
    async_persist: bool = True
    # pipelined durability: save(N) first waits (bounded) until save(N-1) is
    # persisted+backed-up. Zero stall in steady state (intervals >> persist
    # time), backpressure when the reconciler lags, and a deterministic
    # bounded-staleness guarantee: on any single-node crash the recovery
    # point is >= N-1, i.e. lost work <= 2 checkpoint intervals.
    pipeline_durability: bool = True
    durability_timeout_s: float = 60.0
    copy_threads: int = 2
    mem_bw: float = MEM_BW            # modelled B_mem for cache writes
    # ---- datapath knobs ------------------------------------------------- #
    parallel_puts: bool = True        # per-rank cache puts/fetches on a pool
    delta: bool = True                # persist/backup only changed leaves
    codec: str = "raw"                # persist/backup payload: raw|zlib|int8
    # async CPU accounting: digest + encode work in the reconciler charged
    # to the modelled clock as bytes * cycles/byte / cpu_hz (historically
    # only byte *transfers* were charged; the crc/compress CPU was free).
    # ~3 cycles/byte ≈ software crc32 + copy on a ~2.5 GHz datacenter core.
    # 0 disables the charge.
    reconcile_cpu_cycles_per_byte: float = 3.0
    reconcile_cpu_hz: float = 2.5e9
    # leaves matching these fnmatch patterns are never quantised (int8 codec
    # demotes them to lossless zlib) — optimizer-critical state stays exact
    lossless_paths: Tuple[str, ...] = ("*opt*", "*adam*", "*mu*", "*nu*",
                                       "*step*", "*scale*")
    # A/B switch: the pre-datapath behaviour (serial puts, bounce-buffer
    # staging, copying cache reads, double reconciler gets, full re-persist
    # every save, tobytes() checksums); the reference's
    # benchmarks/fig8_tce.py measures both.
    legacy_datapath: bool = False
    # ---- N-tier hierarchy ------------------------------------------------ #
    # None keeps the classic 3-leg cache→ring-backup→NAS waterfall
    # byte-identical. A TierTable additionally enables the device-tier
    # snapshot (zero-copy reference to the last saved state, wiped on node
    # failure), tier-constrained restores (the planner's
    # ``choose_restore_plan`` tiers gate each waterfall leg) and, with a
    # TieredStore, capacity-driven demotion down the durable legs.
    tier_table: Optional[TierTable] = None


class PrefetchHandle:
    """One speculative restore stream started ahead of the actual restore.

    The handle carries the shards already read (real bytes, so the later
    restore is bit-exact) plus the modelled stream window ``[t0, t0 +
    duration_s]``. When the restore consumes the handle it charges only the
    *residual* — the part of the stream that had not finished while TOL was
    still electing/warming replacements — which is the whole point: restore
    bytes overlap election instead of following it."""

    def __init__(self, step: int, tier: str, t0: float, duration_s: float,
                 nbytes: int, ranks: List[NodeShards]):
        self.step = step
        self.tier = tier
        self.t0 = t0
        self.duration_s = duration_s
        self.nbytes = nbytes
        self.ranks = ranks
        self.used = False

    def residual_s(self, now: float) -> float:
        return max(0.0, self.t0 + self.duration_s - now)


class SaveHandle:
    """Tracks one checkpoint save; wait() blocks until durable."""

    def __init__(self, step: int, engine: "TCEngine"):
        self.step = step
        self._engine = engine
        self.cache_wall_s: float = 0.0       # real time to reach cache (blocking)
        self.modeled_cache_s: float = 0.0    # staged bytes / B_mem (paper's metric)
        self.nbytes: int = 0                 # logical checkpoint bytes
        self.bytes_staged: int = 0           # bytes that had to reach the arena
        # global-METER delta across the staging window; exact when the
        # reconciler is quiescent during the stall (pipeline_durability, the
        # default) — concurrent async persist traffic lands here otherwise
        self.bytes_copied: int = 0

    def wait(self, timeout: float = 60.0) -> bool:
        """Block until the step is persisted + backed up (reconciled)."""
        return self._engine.reconciler.quiesce(timeout)


class TCEngine:
    def __init__(self, cfg: TCEConfig, store: DiskStore,
                 fabric: Optional[Fabric] = None,
                 clock: Optional[SimClock] = None,
                 topology: Optional[Topology] = None):
        self.cfg = cfg
        self.store = store
        if clock is None:
            # one clock for the whole substrate: prefer whatever the fabric /
            # topology / store already tick on before minting a new one
            for owner in (fabric, topology, store):
                clock = getattr(owner, "clock", None)
                if clock is not None:
                    break
        self.clock = clock or SimClock()
        self.topology = topology if topology is not None \
            else getattr(fabric, "topology", None)
        self.fabric = fabric if fabric is not None \
            else Fabric(clock=self.clock, topology=self.topology)
        evict = EvictionConfig(cfg.mem_limit_bytes, cfg.max_cycles)
        self.caches = [CacheServer(r, evict, legacy=cfg.legacy_datapath)
                       for r in range(cfg.n_nodes)]
        cpu_s_per_byte = (cfg.reconcile_cpu_cycles_per_byte
                          / cfg.reconcile_cpu_hz
                          if cfg.reconcile_cpu_hz > 0 else 0.0)
        self.reconciler = Reconciler(self.caches, store, self.fabric,
                                     backup=cfg.backup, clock=self.clock,
                                     delta=cfg.delta, codec=cfg.codec,
                                     lossless_paths=cfg.lossless_paths,
                                     legacy=cfg.legacy_datapath,
                                     cpu_s_per_byte=cpu_s_per_byte)
        self._parallel = cfg.parallel_puts and not cfg.legacy_datapath \
            and cfg.n_nodes > 1
        self._pool = ThreadPoolExecutor(
            max_workers=min(cfg.n_nodes, 16),
            thread_name_prefix="tce") if self._parallel else None
        if cfg.async_persist:
            self.reconciler.start()
        self.stats = {"saves": 0, "restores": 0, "fetch_requests": 0,
                      "fetch_transfers": 0, "restore_sources": {}}
        self._lock = threading.Lock()
        self.tiers = cfg.tier_table
        # device-tier snapshot: (step, flat state) kept by reference — the
        # HBM copy of the state that was just checkpointed. Zero cost to
        # keep, gone the instant a node is.
        self._device: Optional[Tuple[int, Dict[str, np.ndarray]]] = None

    # ------------------------------------------------------------------ #
    def close(self) -> None:
        self.reconciler.stop()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None   # engine stays usable (serial) after close

    def _map(self, fn, items):
        if self._parallel and self._pool is not None:
            return list(self._pool.map(fn, items))
        return [fn(x) for x in items]

    # ------------------------------------------------------------------ #
    def save(self, step: int, state, *, meta: Optional[dict] = None,
             wait: bool = False) -> SaveHandle:
        """Checkpoint `state` (pytree or flat dict). Blocks only for the
        in-memory cache write; persistence + backup happen asynchronously."""
        flat = state if isinstance(state, dict) and all(
            isinstance(v, np.ndarray) for v in state.values()) \
            else flatten_pytree(state)
        handle = SaveHandle(step, self)
        if self.cfg.async_persist and self.cfg.pipeline_durability:
            # bounded-staleness pipeline: previous checkpoints become durable
            # before this one enters the cache (no-op in steady state)
            self.reconciler.quiesce(self.cfg.durability_timeout_s)
        meter0 = METER.read()
        t0 = time.perf_counter()
        per_node = shard_state(flat, self.cfg.n_nodes)

        def _put(rank: int) -> PutStats:
            return self.caches[rank].put(step, per_node[rank],
                                         n_threads=self.cfg.copy_threads)

        puts = self._map(_put, range(self.cfg.n_nodes))
        handle.cache_wall_s = time.perf_counter() - t0
        handle.nbytes = sum(p.nbytes for p in puts)
        handle.bytes_staged = sum(p.bytes_staged for p in puts)
        handle.bytes_copied = METER.read() - meter0
        # nodes write their caches in parallel -> modelled latency is the max
        handle.modeled_cache_s = max(p.bytes_staged for p in puts) \
            / self.cfg.mem_bw
        self.clock.advance(handle.modeled_cache_s)
        if self.tiers is not None and TIER_DEVICE in self.tiers:
            self._device = (step, flat)
        with self._lock:
            self.stats["saves"] += 1
        if not self.cfg.async_persist:
            self.reconciler.reconcile_once()
        else:
            self.reconciler.kick()
        if wait:
            handle.wait()
        return handle

    # ------------------------------------------------------------------ #
    def _fetch_backup(self, step: int, owner: int,
                      memo: Dict[Tuple[int, int], Optional[NodeShards]],
                      memo_lock: Optional[threading.Lock] = None
                      ) -> Optional[NodeShards]:
        """Fetch `owner`'s shards from its ring neighbour's cache (dedup'd)."""
        key = (step, owner)
        with self._lock:
            self.stats["fetch_requests"] += 1
        lock = memo_lock or threading.Lock()
        with lock:
            if key in memo:
                return memo[key]
        holder = (owner + 1) % self.cfg.n_nodes
        shards = None
        if not self.fabric.is_down(holder):
            backup = self.caches[holder].get(step, owner_rank=owner)
            if backup is not None:
                payload = {p: d for p, (sp, d) in backup.items()}
                try:
                    # the consumer is the replacement node for `owner`
                    self.fabric.send(holder, owner, payload, check_dst=False)
                    with self._lock:
                        self.stats["fetch_transfers"] += 1
                    shards = backup
                except TransportError:
                    shards = None
        with lock:
            memo[key] = shards
        return shards

    def restore(self, step: Optional[int] = None,
                consumers_per_node: int = 1, *,
                plan=None, prefetch: Optional[PrefetchHandle] = None
                ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Waterfall restore. Returns (step, flat state dict).

        With step=None, candidate steps are tried newest-first: a checkpoint
        whose async backup/persist had not completed when the failure hit is
        skipped in favour of the freshest *recoverable* one.

        Cache/backup fetches for all ranks run concurrently on the thread
        pool; the in-memory read is charged to the modelled clock at B_mem
        (max per-node bytes — nodes read in parallel), fabric and NAS
        transfers charge through their own bandwidth models.

        ``plan`` (a planner :class:`~repro.recovery.planner.RestorePlan` or
        an iterable of tier names) constrains which hierarchy legs this
        restore may touch: device snapshot / local cache ("dram") / ring
        backup ("peer") / the durable store legs. ``prefetch`` consumes a
        speculative stream from :meth:`prefetch_restore` — store-leg bytes
        already streamed while TOL was electing charge only their residual.

        The returned state is the *global* (unsharded) state: a checkpoint
        written on N nodes restores through the ``store_full`` path onto an
        engine with M != N nodes, and the caller re-shards by saving through
        the new engine (elastic shrink/grow).
        """
        allowed = None
        if plan is not None:
            allowed = frozenset(getattr(plan, "tiers", plan))
        tiered_store = getattr(self.store, "tiered", False)
        store_kw = {"tiers": allowed} if (tiered_store and allowed) else {}
        dev = self._device if (
            self.tiers is not None and self._device is not None
            and (allowed is None or TIER_DEVICE in allowed)) else None
        if step is None:
            cached = {s for c in self.caches for s in c.steps()}
            cached.update(self.store.steps(**store_kw))
            if dev is not None:
                cached.add(dev[0])
            if not cached:
                raise FileNotFoundError("no checkpoint available")
            last_err: Optional[Exception] = None
            for cand in sorted(cached, reverse=True):
                try:
                    return self.restore(step=cand,
                                        consumers_per_node=consumers_per_node,
                                        plan=plan, prefetch=prefetch)
                except FileNotFoundError as e:
                    last_err = e
            raise last_err
        if dev is not None and dev[0] == step:
            # hottest tier: the HBM snapshot of the very state that was
            # checkpointed — a reference copy, charged at device read bw
            flat = dict(dev[1])
            total = sum(a.nbytes for a in flat.values())
            self.clock.advance(self.tiers.get(TIER_DEVICE).read_s(total))
            with self._lock:
                self.stats["restores"] += 1
                self.stats["restore_sources"] = {"device": self.cfg.n_nodes}
            return step, flat
        use_cache = allowed is None or TIER_DRAM in allowed
        use_backup = allowed is None or TIER_PEER in allowed
        memo: Dict[Tuple[int, int], Optional[NodeShards]] = {}
        memo_lock = threading.Lock()
        sources = {"cache": 0, "backup": 0, "store": 0, "store_full": 0}
        try:
            store_ranks = self.store.manifest(step, **store_kw)["n_ranks"]
        except Exception:
            store_ranks = None
        pf = prefetch if (prefetch is not None and not prefetch.used
                          and prefetch.step == step) else None
        pf_hit = False

        def _resolve_mem(rank: int) -> Tuple[Optional[str], Optional[NodeShards]]:
            """Cache/backup waterfall for one rank (store stays serial)."""
            if use_cache and not self.fabric.is_down(rank):
                shards = self.caches[rank].get(step)
                if shards is not None:
                    return "cache", shards
            if not use_backup:
                return None, None
            # consumers on the node all want the same remote shards; the
            # fetch is deduplicated through `memo`
            for _ in range(max(consumers_per_node - 1, 0)):
                self._fetch_backup(step, rank, memo, memo_lock)
            shards = self._fetch_backup(step, rank, memo, memo_lock)
            if shards is not None:
                return "backup", shards
            return None, None

        resolved = self._map(_resolve_mem, range(self.cfg.n_nodes))

        per_node: List[Optional[NodeShards]] = []
        full_read = False
        for rank, (src, shards) in enumerate(resolved):
            if shards is None:
                if store_ranks == self.cfg.n_nodes:
                    # NAS reads are serial: the store is the modelled shared
                    # bottleneck (and SharedBandwidth charging is not
                    # reentrant). A live prefetch already holds these bytes.
                    if pf is not None and len(pf.ranks) == store_ranks:
                        shards = pf.ranks[rank]
                        pf_hit = True
                    else:
                        shards = self.store.read_rank(step, rank, **store_kw)
                    src = "store"
                elif store_ranks is not None:
                    # topology changed since this step was written: fall back
                    # to a full store read in the manifest's own rank layout
                    # (elastic reshard path)
                    if pf is not None and len(pf.ranks) == store_ranks:
                        per_node = list(pf.ranks)
                        pf_hit = True
                    else:
                        per_node = self.store.read_all(step, **store_kw)
                    sources["store_full"] = 1
                    full_read = True
                    break
                else:
                    raise FileNotFoundError(
                        f"step {step}: rank {rank} unrecoverable "
                        f"(cache lost, backup lost, not persisted)")
            sources[src] += 1
            per_node.append(shards)
        if pf_hit:
            # the speculative stream ran while TOL was electing; charge only
            # the part that had not finished by now
            pf.used = True
            residual = pf.residual_s(self.clock.seconds)
            self.clock.advance(residual)
            overlap = pf.duration_s - residual
            with self._lock:
                self.stats["prefetch"] = {
                    "bytes": pf.nbytes, "tier": pf.tier,
                    "duration_s": pf.duration_s, "overlap_s": overlap,
                    "overlap_frac": (overlap / pf.duration_s
                                     if pf.duration_s > 0 else 1.0)}
        if not full_read:
            # local in-memory reads happen in parallel across nodes: charge
            # the max per-node byte count at B_mem on the modelled clock
            # (fabric/NAS legs already charged themselves)
            mem_bytes = [sum(d.nbytes for _, d in shards.values())
                         for (src, _), shards in zip(resolved, per_node)
                         if src == "cache" and shards]
            if mem_bytes:
                self.clock.advance(max(mem_bytes) / self.cfg.mem_bw)
        state = unshard_state(per_node)
        with self._lock:
            self.stats["restores"] += 1
            self.stats["restore_sources"] = sources
        return step, state

    # ------------------------------------------------------------------ #
    def prefetch_restore(self, step: Optional[int] = None, *,
                         plan=None) -> Optional[PrefetchHandle]:
        """Start a speculative restore stream from the durable store.

        Called the moment a fault is detected — while TOL is still running
        checks, electing replacements and warming them up — so the
        store-leg bytes stream *during* the election window instead of
        after it. Reads the freshest committed step's shards for real (the
        later restore is bit-exact) but charges nothing to the modelled
        clock yet: the stream's window is ``[now, now + bytes/bw]`` and
        :meth:`restore` charges only whatever residual is left when it
        consumes the handle.

        Returns None when there is nothing durable to prefetch (the
        restore will resolve from cache/backup anyway).
        """
        allowed = None
        if plan is not None:
            allowed = frozenset(getattr(plan, "tiers", plan))
        tiered_store = getattr(self.store, "tiered", False)
        store_kw = {"tiers": allowed} if (tiered_store and allowed) else {}
        try:
            if step is None:
                step = self.store.latest_step(**store_kw)
            if step is None:
                return None
            if tiered_store:
                tier, leg = self.store._leg_for(step, allowed)
            else:
                tier, leg = TIER_NAS, self.store
            m = leg.manifest(step)
        except (FileNotFoundError, KeyError):
            return None
        ranks: List[NodeShards] = []
        nbytes = 0
        for r in range(int(m["n_ranks"])):
            shards, stored = leg._read_rank_impl(step, r)
            ranks.append(shards)
            nbytes += stored
        if self.tiers is not None and tier in self.tiers:
            bw = self.tiers.get(tier).read_bw
        else:
            bw = getattr(leg, "bw", NAS_BW_PER_RANK)
        duration = nbytes / bw if bw > 0 else 0.0
        return PrefetchHandle(step, tier, self.clock.seconds, duration,
                              nbytes, ranks)

    # ------------------------------------------------------------------ #
    # Failure hooks (driven by TOL)
    # ------------------------------------------------------------------ #
    def node_failed(self, rank: int) -> None:
        """Node crash: its cache (incl. backups it held) is gone — and so
        is the device-tier snapshot (it lived in the gang's HBM)."""
        self._device = None
        self.caches[rank].wipe()
        self.fabric.fail_node(rank)

    def node_recovered(self, rank: int, *, fresh: bool = True) -> None:
        """Node rejoins (possibly a fresh machine): autonomously restore its
        lost cache from the previous node's backup and re-backup."""
        self.fabric.restore_node(rank)
        if fresh:
            self.caches[rank].wipe()
        # pull own shards back from ring neighbour for every step it backed up
        memo: Dict[Tuple[int, int], Optional[NodeShards]] = {}
        holder = (rank + 1) % self.cfg.n_nodes
        for step in self.caches[holder].steps(include_backups=True):
            shards = self._fetch_backup(step, rank, memo)
            if shards is not None:
                self.caches[rank].put(step, shards)
                self.caches[rank].mark(step, persisted=True, backed_up=True)
        self.reconciler.kick()
