"""Persistent checkpoint stores.

``DiskStore`` is the reliable backing store (atomic manifest rename +
checksums — a half-written checkpoint is never visible). ``NASStore`` wraps it
with the paper's measured network-attached-storage bandwidth (71.1 MB/s per
rank on SenseCore file storage) on a modelled clock, so benchmarks can report
paper-comparable save/load latencies while the bytes really move through the
same code path.

Datapath (this store is the tail of the zero-copy pipeline):

* Shard payloads are written as raw byte files (``shard_*.bin``) straight
  from arena views — no ``np.save`` header copies, no ``tobytes()``;
  checksums are computed *streaming* over memoryviews.
* **Delta checkpoints**: ``write_rank`` accepts ``refs`` — leaves unchanged
  since an earlier persisted step are recorded as ``{"ref_step": S}`` index
  entries pointing at the step whose file actually holds the bytes (refs are
  path-compressed, so chain resolution is always one hop per leaf, however
  long the manifest-level chain ``delta_base`` records). Only changed bytes
  hit the NAS.
* **Codecs**: payloads may be zlib (lossless, bit-exact) or int8
  blockwise-quantised (the quant_blockwise kernels, on the store's
  ``device``) — see :mod:`.codec`. The index stores
  both the stored-payload crc (corruption detection) and the raw-content
  digest (delta bookkeeping).

``delete_step`` refuses to delete a step that later delta steps still
reference (:class:`ChainIntegrityError`); pass ``rematerialize=True`` to
migrate the referenced payloads into their dependents first, or
``force=True`` to knowingly strand them.

``TieredStore`` stacks several durable stores into the N-tier checkpoint
hierarchy (rack SSD burst buffer → NAS → cold object store): writes land on
the hottest leg, reads resolve from the hottest leg that still holds the
step, and ``demote_due`` ages steps down the ladder when a leg runs over
its tier's capacity budget — rematerializing delta chains on the way so
demotion never strands a dependent.

Counterpart of ``repro.core.tce.store``, with the same directory layout,
index entries and delta-chain rules, so a checkpoint written by either
package reads in the other. The one addition is ``device``: where an
``int8`` leaf is quantised or dequantised (default ``cuda``). A namespace
inherits it, and a ``TieredStore`` reports its primary leg's.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.sim.clock import SimClock  # noqa: F401  (canonical clock; re-exported)

from .codec import decode_shard, dtype_name, encode_shard, is_lossless_path
from .fastcopy import METER, crc32_stream
from .sharding import NodeShards, ShardSpec

NAS_BW_PER_RANK = 71.1e6  # bytes/s — paper §IV-C: "roughly 71.1MB/s per rank"


class ChainIntegrityError(RuntimeError):
    """Deleting this step would strand delta leaves that reference it."""


class SharedBandwidth:
    """Processor-sharing model of one shared NAS uplink.

    ``k`` concurrent flows each progress at ``bw_total / k``: one job's
    restore waterfall visibly slows another job's async checkpoint save.
    Flows are tracked in *modelled* time supplied by the caller — start a
    flow with :meth:`start`, then either drain completions event-style
    (:meth:`next_completion` / :meth:`take_completed`, the fleet engine's
    path) or charge a blocking transfer (:meth:`transfer`, the
    :class:`NASStore` path).
    """

    def __init__(self, bw_total: float):
        if bw_total <= 0:
            raise ValueError("bw_total must be > 0")
        self.bw = float(bw_total)
        # completion slack: remaining work finishable in < 1 ns at full
        # bandwidth counts as done (float residue from share arithmetic
        # must not stall the virtual clock)
        self._eps = self.bw * 1e-9
        self._t = 0.0                       # internal virtual time
        self._next_id = 0
        self._flows: Dict[int, List] = {}   # id -> [remaining_bytes, label]
        self._done: List[tuple] = []        # (t_done, id, label)
        # rate-change epoch: bumped whenever the active flow set changes
        # (start / cancel / completion), i.e. whenever every survivor's fair
        # share — and therefore any cached next_completion() prediction —
        # becomes stale. Callers key caches on (epoch, virtual_time).
        self.epoch = 0
        self.stats = {"flows": 0, "bytes": 0, "contended_flows": 0,
                      "peak_concurrency": 0}

    # -- flow lifecycle -------------------------------------------------- #
    def active(self) -> int:
        return len(self._flows)

    @property
    def virtual_time(self) -> float:
        """The arbiter's internal virtual clock (last drain point)."""
        return self._t

    def start(self, t: float, nbytes: float, label: str = "flow") -> int:
        """Register a flow of ``nbytes`` starting at modelled time ``t``."""
        self._drain(t)
        fid = self._next_id
        self._next_id += 1
        self._flows[fid] = [float(max(nbytes, 1.0)), label]
        self.epoch += 1
        self.stats["flows"] += 1
        self.stats["bytes"] += int(nbytes)
        if len(self._flows) > 1:
            self.stats["contended_flows"] += 1
        self.stats["peak_concurrency"] = max(self.stats["peak_concurrency"],
                                             len(self._flows))
        return fid

    def cancel(self, fid: int) -> None:
        """Abort a flow (a crash tears down an in-flight save)."""
        if self._flows.pop(fid, None) is not None:
            self.epoch += 1

    def next_completion(self) -> Optional[float]:
        """Earliest flow-completion time, assuming no new arrivals (shares
        only grow after a completion, so the *first* finisher's share is
        exactly ``bw / k`` throughout)."""
        if not self._flows:
            return None
        k = len(self._flows)
        return self._t + min(r for r, _ in self._flows.values()) * k / self.bw

    def take_completed(self, t: float) -> List[tuple]:
        """Advance to ``t`` and return ``(t_done, flow_id, label)`` for every
        flow that finished, in completion order."""
        self._drain(t)
        out, self._done = self._done, []
        return out

    def transfer(self, t: float, nbytes: float, label: str = "io") -> float:
        """Blocking charge: start a flow at ``t`` and run it to completion
        (no further arrivals assumed). Returns the modelled duration — with
        no other active flow this degenerates to ``nbytes / bw``."""
        fid = self.start(t, nbytes, label)
        while fid in self._flows:
            self._drain(self.next_completion())
        for i in range(len(self._done) - 1, -1, -1):
            if self._done[i][1] == fid:
                return self._done.pop(i)[0] - t
        raise AssertionError(f"flow {fid} vanished without completing")

    # -- internals -------------------------------------------------------- #
    def _drain(self, t: float) -> None:
        """Advance virtual time to ``t``, progressing every active flow at
        its fair share and logging completions as shares grow."""
        t = max(t, self._t)
        while self._flows and self._t < t:
            k = len(self._flows)
            share = self.bw / k
            dt_next = min(r for r, _ in self._flows.values()) / share
            step = min(dt_next, t - self._t)
            for f in self._flows.values():
                f[0] -= share * step
            self._t += step
            for fid in sorted(f for f, v in self._flows.items()
                              if v[0] <= self._eps):
                _, label = self._flows.pop(fid)
                self.epoch += 1
                self._done.append((self._t, fid, label))
        self._t = t


class DiskStore:
    """step -> {rank -> NodeShards}; manifest written last, atomically.

    ``device`` is where ``int8`` leaves are (de)quantised. ``legacy_crc=True`` restores the pre-datapath full-buffer ``tobytes()``
    checksum copies (for A/B benchmarking only).
    """

    def __init__(self, root: str, *, legacy_crc: bool = False, device=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.legacy_crc = legacy_crc
        self.device = device
        self.stats = {"bytes_stored": 0, "bytes_raw": 0, "leaves_written": 0,
                      "leaves_ref": 0, "bytes_read_stored": 0,
                      "leaves_rematerialized": 0}

    def namespace(self, job_id: str) -> "DiskStore":
        """A per-job checkpoint namespace inside this shared store root.

        Co-located fleet jobs write the same step keys; namespacing keeps
        ``<root>/ns_<job>/step_*`` trees disjoint so they can never collide
        on a step directory or overwrite each other's manifests. Subclasses
        share their bandwidth model (one NAS under all namespaces)."""
        import zlib as _zlib
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in job_id)
        if safe != job_id:
            # sanitisation must stay injective: "job/1" and "job:1" both
            # map to "job_1", so disambiguate with a hash of the raw id
            safe += f"-{_zlib.crc32(job_id.encode()) & 0xFFFFFFFF:08x}"
        return type(self)(str(self.root / f"ns_{safe}"),
                          **self._namespace_kwargs())

    def _namespace_kwargs(self) -> dict:
        return {"legacy_crc": self.legacy_crc, "device": self.device}

    # -- paths ---------------------------------------------------------- #
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _rank_dir(self, step: int, rank: int) -> Path:
        return self._step_dir(step) / f"rank_{rank:05d}"

    def _manifest(self, step: int) -> Path:
        return self._step_dir(step) / "manifest.json"

    def _crc(self, data) -> int:
        if self.legacy_crc:
            import zlib
            buf = (np.ascontiguousarray(data).tobytes()
                   if isinstance(data, np.ndarray) else bytes(data))
            METER.add(len(buf))              # the copy tobytes() materialises
            return zlib.crc32(buf) & 0xFFFFFFFF
        return crc32_stream(data)

    # -- write ---------------------------------------------------------- #
    def write_rank(self, step: int, rank: int, shards: NodeShards, *,
                   refs: Optional[Dict[str, Tuple[int, int]]] = None,
                   digests: Optional[Dict[str, int]] = None,
                   codec: str = "raw",
                   lossless_paths: Tuple[str, ...] = ()) -> int:
        """Persist one rank's shards. Returns bytes physically stored.

        ``refs`` maps unchanged paths to ``(home_step, content_token)`` —
        those leaves are recorded as index references instead of being
        rewritten (``home_step`` is the step whose rank dir holds the actual
        file). ``digests`` records the caller's content tokens for written
        leaves (delta bookkeeping); absent, a crc of the raw bytes is stored.
        The seconds spent in ``fsync`` are added to the innermost open span
        as ``fsync_s`` (the reconciler's ``tce.persist``; ``repro_torch.obs``).
        """
        d = self._rank_dir(step, rank)
        d.mkdir(parents=True, exist_ok=True)
        refs = refs or {}
        stored_total = 0
        raw_total = 0
        index = []
        for i, (path, (spec, data)) in enumerate(sorted(shards.items())):
            data = np.ascontiguousarray(data)
            raw_total += data.nbytes
            ent = {"spec": spec.to_dict(), "dtype": dtype_name(data.dtype),
                   "shape": list(data.shape), "nbytes_raw": int(data.nbytes)}
            if path in refs:
                home_step, digest = refs[path]
                ent.update({"ref_step": int(home_step), "digest": int(digest)})
                index.append(ent)
                self.stats["leaves_ref"] += 1
                continue
            enc, payload, meta = encode_shard(
                data, codec,
                lossless=is_lossless_path(path, lossless_paths),
                device=self.device)
            fname = f"shard_{i:05d}.bin"
            tmp = d / (fname + ".tmp")
            with open(tmp, "wb") as f:
                f.write(memoryview(payload))
                f.flush()
                t_sync = time.perf_counter()
                os.fsync(f.fileno())
                obs.add(fsync_s=time.perf_counter() - t_sync)
            os.replace(tmp, d / fname)   # atomic
            stored_total += payload.nbytes
            digest = (digests[path] if digests and path in digests
                      else self._crc(data))
            ent.update({"file": fname, "enc": enc, "meta": meta,
                        "crc32": int(self._crc(payload)),
                        "digest": int(digest),
                        "nbytes_stored": int(payload.nbytes)})
            index.append(ent)
            self.stats["leaves_written"] += 1
        tmp = d / "index.json.tmp"
        tmp.write_text(json.dumps(index))
        os.replace(tmp, d / "index.json")
        self.stats["bytes_stored"] += stored_total
        self.stats["bytes_raw"] += raw_total
        return stored_total

    def commit(self, step: int, n_ranks: int, meta: Optional[dict] = None,
               delta_base: Optional[int] = None) -> None:
        """Write the manifest — the checkpoint becomes visible atomically.

        ``delta_base`` chains this manifest to the previous durable step its
        rank indexes may reference (informational; index refs are the
        authoritative, path-compressed pointers)."""
        m = {"step": step, "n_ranks": n_ranks, "meta": meta or {},
             "delta_base": delta_base, "time": time.time()}
        tmp = self._manifest(step).with_suffix(".tmp")
        tmp.write_text(json.dumps(m))
        os.replace(tmp, self._manifest(step))

    # -- read ----------------------------------------------------------- #
    def steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*/manifest.json"):
            try:
                out.append(json.loads(p.read_text())["step"])
            except Exception:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def manifest(self, step: int) -> dict:
        return json.loads(self._manifest(step).read_text())

    def rank_index(self, step: int, rank: int) -> List[dict]:
        return json.loads((self._rank_dir(step, rank) / "index.json").read_text())

    def read_rank(self, step: int, rank: int, verify: bool = True) -> NodeShards:
        shards, _ = self._read_rank_impl(step, rank, verify)
        return shards

    def _read_rank_impl(self, step: int, rank: int,
                        verify: bool = True) -> Tuple[NodeShards, int]:
        """Read one rank's shards, resolving delta refs. Returns
        ``(shards, stored_bytes_read)`` — the stored count is what a
        bandwidth model should charge (refs read their home step's file)."""
        index = self.rank_index(step, rank)
        out: NodeShards = {}
        stored_read = 0
        # steady-state delta checkpoints point many leaves at the same home
        # step — parse each referenced index.json once, not once per leaf
        home_indexes: Dict[int, Dict[str, dict]] = {}

        def _home_index(home: int) -> Dict[str, dict]:
            if home not in home_indexes:
                home_indexes[home] = {e["spec"]["path"]: e
                                      for e in self.rank_index(home, rank)}
            return home_indexes[home]

        for ent in index:
            spec = ShardSpec.from_dict(ent["spec"])
            home = step
            hops = 0
            resolved = ent
            while "file" not in resolved:
                home = int(resolved["ref_step"])
                resolved = _home_index(home).get(spec.path)
                if resolved is None:
                    raise IOError(f"delta ref broken: {spec.path} missing "
                                  f"from step {home} rank {rank}")
                hops += 1
                if hops > 64:
                    raise IOError(f"delta ref cycle for {spec.path}")
            fpath = self._rank_dir(home, rank) / resolved["file"]
            payload = np.fromfile(fpath, np.uint8)
            stored_read += payload.nbytes
            if verify and int(self._crc(payload)) != resolved["crc32"]:
                raise IOError(f"checksum mismatch for {spec.path} in rank {rank}")
            data = decode_shard(resolved.get("enc", "raw"), payload,
                                ent["dtype"], ent["shape"],
                                resolved.get("meta"), device=self.device)
            out[spec.path] = (spec, data)
        self.stats["bytes_read_stored"] += stored_read
        return out, stored_read

    def read_all(self, step: int) -> List[NodeShards]:
        m = self.manifest(step)
        return [self.read_rank(step, r) for r in range(m["n_ranks"])]

    def has_step(self, step: int) -> bool:
        """True if the step is committed here (manifest visible)."""
        return self._manifest(step).exists()

    # -- chain-safe GC --------------------------------------------------- #
    def chain_dependents(self, step: int) -> List[int]:
        """Steps whose rank indexes still hold delta refs into ``step``.

        Refs are path-compressed (each points straight at the step whose
        rank dir holds the bytes), so one scan of every other step's index
        files finds every inbound edge."""
        deps = set()
        for d in self.root.glob("step_*"):
            try:
                other = int(d.name.split("_", 1)[1])
            except (IndexError, ValueError):
                continue
            if other == step:
                continue
            for idx in d.glob("rank_*/index.json"):
                try:
                    index = json.loads(idx.read_text())
                except Exception:
                    continue
                if any(int(e.get("ref_step", -1)) == step for e in index):
                    deps.add(other)
                    break
        return sorted(deps)

    def rematerialize_step(self, step: int) -> int:
        """Copy ``step``'s payloads into every dependent's rank dir and
        rewrite their refs as self-contained file entries, so ``step`` can
        be deleted without stranding the chain. Returns bytes copied."""
        copied = 0
        for dep in self.chain_dependents(step):
            m = self.manifest(dep)
            for rank in range(int(m["n_ranks"])):
                rdir = self._rank_dir(dep, rank)
                try:
                    index = self.rank_index(dep, rank)
                except FileNotFoundError:
                    continue
                home = {e["spec"]["path"]: e
                        for e in self.rank_index(step, rank)}
                changed = False
                for ent in index:
                    if int(ent.get("ref_step", -1)) != step:
                        continue
                    src = home.get(ent["spec"]["path"])
                    if src is None:
                        raise ChainIntegrityError(
                            f"step {dep} rank {rank} refs "
                            f"{ent['spec']['path']} missing from step {step}")
                    if "file" not in src:
                        # the home entry is itself a (deeper) ref: just
                        # repoint the dependent one hop further down
                        ent["ref_step"] = int(src["ref_step"])
                        changed = True
                        continue
                    fname = f"rm{step:08d}_{src['file']}"
                    payload = np.fromfile(
                        self._rank_dir(step, rank) / src["file"], np.uint8)
                    tmp = rdir / (fname + ".tmp")
                    with open(tmp, "wb") as f:
                        f.write(memoryview(payload))
                        f.flush()
                        os.fsync(f.fileno())
                    os.replace(tmp, rdir / fname)
                    METER.add(payload.nbytes)
                    copied += payload.nbytes
                    ent.pop("ref_step", None)
                    ent.update({"file": fname,
                                "enc": src.get("enc", "raw"),
                                "meta": src.get("meta"),
                                "crc32": int(src["crc32"]),
                                "digest": int(src["digest"]),
                                "nbytes_stored": int(src["nbytes_stored"])})
                    self.stats["leaves_rematerialized"] += 1
                    changed = True
                if changed:
                    tmp = rdir / "index.json.tmp"
                    tmp.write_text(json.dumps(index))
                    os.replace(tmp, rdir / "index.json")
        self.stats["bytes_stored"] += copied
        return copied

    def delete_step(self, step: int, *, rematerialize: bool = False,
                    force: bool = False) -> None:
        """Delete one step — refusing, by default, to strand a chain.

        If other steps' delta refs still point into this one, deletion
        raises :class:`ChainIntegrityError` unless ``rematerialize=True``
        (migrate the shared payloads into the dependents first) or
        ``force=True`` (the historical unchecked behaviour)."""
        import shutil
        if not force:
            deps = self.chain_dependents(step)
            if deps:
                if not rematerialize:
                    raise ChainIntegrityError(
                        f"step {step} is still the delta base of "
                        f"step(s) {deps}; pass rematerialize=True to "
                        "migrate the chain or force=True to strand it")
                self.rematerialize_step(step)
        shutil.rmtree(self._step_dir(step), ignore_errors=True)


class NASStore(DiskStore):
    """DiskStore + modelled NAS bandwidth per rank (paper's baseline medium).

    With an ``arbiter`` (:class:`SharedBandwidth`) the store's transfers are
    charged at their *contended* fair share — concurrent modelled flows from
    other jobs on the same NAS slow this store's saves and restores down.
    Without one, each transfer gets the full per-rank bandwidth (the
    historical single-job behaviour).

    Transfers are charged on **stored** bytes — delta refs and compressed
    payloads cut modelled NAS time proportionally, which is the point of the
    datapath.
    """

    def __init__(self, root: str, bw_per_rank: float = NAS_BW_PER_RANK,
                 clock: Optional[SimClock] = None,
                 arbiter: Optional[SharedBandwidth] = None, *,
                 legacy_crc: bool = False, device=None):
        super().__init__(root, legacy_crc=legacy_crc, device=device)
        self.bw = bw_per_rank
        self.clock = clock or SimClock()
        self.arbiter = arbiter

    def _namespace_kwargs(self) -> dict:
        # namespaces share the clock AND the arbiter: co-located jobs'
        # saves/restores still contend for the one modelled NAS uplink
        return {"bw_per_rank": self.bw, "clock": self.clock,
                "arbiter": self.arbiter, "legacy_crc": self.legacy_crc,
                "device": self.device}

    def _charge(self, nbytes: int, label: str) -> None:
        if self.arbiter is not None:
            self.clock.advance(
                self.arbiter.transfer(self.clock.seconds, nbytes, label))
        else:
            self.clock.advance(nbytes / self.bw)

    def write_rank(self, step: int, rank: int, shards: NodeShards,
                   **kw) -> int:
        nbytes = super().write_rank(step, rank, shards, **kw)
        self._charge(nbytes, f"save_r{rank}")
        return nbytes

    def read_rank(self, step: int, rank: int, verify: bool = True) -> NodeShards:
        out, stored_read = self._read_rank_impl(step, rank, verify)
        self._charge(stored_read, f"restore_r{rank}")
        return out


class ModeledStore(NASStore):
    """One durable leg of the tier hierarchy at an arbitrary modelled
    bandwidth — NASStore mechanics with a tier name and (optionally)
    asymmetric read/write bandwidth, for the rack burst-buffer SSD and the
    cold object store."""

    def __init__(self, root: str, *, tier_name: str = "nas",
                 bw_read: float = NAS_BW_PER_RANK,
                 bw_write: Optional[float] = None,
                 clock: Optional[SimClock] = None,
                 arbiter: Optional[SharedBandwidth] = None,
                 legacy_crc: bool = False, device=None):
        super().__init__(root, bw_per_rank=bw_read, clock=clock,
                         arbiter=arbiter, legacy_crc=legacy_crc,
                         device=device)
        self.tier_name = tier_name
        self.bw_write = bw_write if bw_write is not None else bw_read

    def _namespace_kwargs(self) -> dict:
        return {"tier_name": self.tier_name, "bw_read": self.bw,
                "bw_write": self.bw_write, "clock": self.clock,
                "arbiter": self.arbiter, "legacy_crc": self.legacy_crc,
                "device": self.device}

    def write_rank(self, step: int, rank: int, shards: NodeShards,
                   **kw) -> int:
        nbytes = DiskStore.write_rank(self, step, rank, shards, **kw)
        if self.arbiter is not None:
            self.clock.advance(self.arbiter.transfer(
                self.clock.seconds, nbytes, f"save_r{rank}"))
        else:
            self.clock.advance(nbytes / self.bw_write)
        return nbytes


class TieredStore:
    """Ordered durable legs of the N-tier hierarchy, hottest leg first.

    DiskStore-compatible surface over a ladder like ssd→nas→cold: writes
    land on the hottest leg; reads resolve from the hottest *up* leg that
    holds the step (restores can constrain that with a planner tier list);
    :meth:`demote_due` ages the oldest steps down the ladder whenever a
    leg runs over its tier's per-rank capacity budget, paying the modelled
    read+write bandwidth of both legs and rematerializing delta chains so
    demotion never strands a dependent. ``fail_tier``/``restore_tier``
    model brownouts and correlated tier loss.
    """

    tiered = True

    def __init__(self, legs: Dict[str, DiskStore], *, table=None,
                 clock: Optional[SimClock] = None,
                 arbiter: Optional[SharedBandwidth] = None):
        if not legs:
            raise ValueError("TieredStore needs at least one leg")
        self.legs = dict(legs)               # insertion order = hot -> cold
        self.order = list(self.legs)
        self.primary = self.legs[self.order[0]]
        self.table = table
        self.clock = clock or getattr(self.primary, "clock", None) \
            or SimClock()
        # shared-NAS arbiter for *background* demotion traffic: when set,
        # every demoted step is additionally charged as a contended transfer
        # on the fleet's uplink, so step aging visibly slows foreground
        # saves/restores instead of moving bytes for free
        self.arbiter = arbiter
        self._down: set = set()
        # "demotion_transfer_s" joins lazily, only when an arbiter charges
        # (existing artifacts embed this dict — don't grow it for free)
        self.stats = {"demotions": 0, "demoted_bytes": 0}

    # -- tier availability ----------------------------------------------- #
    def fail_tier(self, name: str) -> None:
        self._down.add(name)

    def restore_tier(self, name: str) -> None:
        self._down.discard(name)

    def _up(self, name: str) -> bool:
        return name not in self._down

    @property
    def device(self):
        """Where the hottest leg (the one written to) (de)quantises."""
        return self.primary.device

    # -- write path (hottest leg) ---------------------------------------- #
    def write_rank(self, step: int, rank: int, shards: NodeShards, *,
                   refs: Optional[Dict[str, Tuple[int, int]]] = None,
                   **kw) -> int:
        if refs:
            # a ref is only valid if its home step still lives on the
            # primary leg — steps demoted down the ladder are no longer
            # one hop away, so those leaves are rewritten in full
            refs = {p: r for p, r in refs.items()
                    if self.primary.has_step(int(r[0]))}
        return self.primary.write_rank(step, rank, shards, refs=refs, **kw)

    def commit(self, step: int, n_ranks: int, meta: Optional[dict] = None,
               delta_base: Optional[int] = None) -> None:
        if delta_base is not None and not self.primary.has_step(delta_base):
            delta_base = None
        self.primary.commit(step, n_ranks, meta, delta_base)

    # -- read path (hottest up leg holding the step) ---------------------- #
    def _leg_for(self, step: int, tiers=None) -> Tuple[str, DiskStore]:
        for name in self.order:
            if not self._up(name) or (tiers is not None
                                      and name not in tiers):
                continue
            if self.legs[name].has_step(step):
                return name, self.legs[name]
        raise FileNotFoundError(
            f"step {step} not on any reachable tier "
            f"(down: {sorted(self._down)}, allowed: {tiers})")

    def tier_of(self, step: int) -> str:
        return self._leg_for(step)[0]

    def steps(self, tiers=None) -> List[int]:
        out = set()
        for name in self.order:
            if self._up(name) and (tiers is None or name in tiers):
                out.update(self.legs[name].steps())
        return sorted(out)

    def latest_step(self, tiers=None) -> Optional[int]:
        s = self.steps(tiers)
        return s[-1] if s else None

    def manifest(self, step: int, tiers=None) -> dict:
        return self._leg_for(step, tiers)[1].manifest(step)

    def rank_index(self, step: int, rank: int, tiers=None) -> List[dict]:
        return self._leg_for(step, tiers)[1].rank_index(step, rank)

    def read_rank(self, step: int, rank: int, verify: bool = True,
                  tiers=None) -> NodeShards:
        return self._leg_for(step, tiers)[1].read_rank(step, rank, verify)

    def read_all(self, step: int, tiers=None) -> List[NodeShards]:
        name, leg = self._leg_for(step, tiers)
        m = leg.manifest(step)
        return [leg.read_rank(step, r) for r in range(m["n_ranks"])]

    def delete_step(self, step: int, **kw) -> None:
        for name in self.order:
            if self.legs[name].has_step(step):
                self.legs[name].delete_step(step, **kw)

    def has_step(self, step: int) -> bool:
        return any(self.legs[n].has_step(step) for n in self.order
                   if self._up(n))

    # -- tier-aware aging -------------------------------------------------- #
    def _step_stored_bytes(self, leg: DiskStore, step: int) -> int:
        total = 0
        m = leg.manifest(step)
        for r in range(int(m["n_ranks"])):
            try:
                index = leg.rank_index(step, r)
            except FileNotFoundError:
                continue
            total += sum(int(e.get("nbytes_stored", 0)) for e in index)
        return total

    def _capacity(self, name: str) -> int:
        if self.table is not None and name in self.table:
            return int(self.table.get(name).capacity_bytes)
        return 0

    def demote_due(self) -> List[Tuple[int, str, str]]:
        """Enforce each leg's capacity budget by demoting its *oldest*
        steps one rung down (the newest snapshot always stays as hot as
        budget allows). Demotion reads the step fully resolved from the
        source leg and writes it self-contained on the destination, so
        restored pytrees stay bit-exact through demoted delta chains.
        Returns ``[(step, from_tier, to_tier), ...]``; idempotent."""
        moved: List[Tuple[int, str, str]] = []
        for i, name in enumerate(self.order[:-1]):
            cap = self._capacity(name)
            if cap <= 0:
                continue
            src = self.legs[name]
            dst_name = self.order[i + 1]
            dst = self.legs[dst_name]
            steps = src.steps()
            sizes = {s: self._step_stored_bytes(src, s) for s in steps}
            while len(steps) > 1 and sum(sizes.values()) > cap:
                step = steps.pop(0)           # oldest first, never newest
                m = src.manifest(step)
                n_ranks = int(m["n_ranks"])
                nbytes = 0
                for r in range(n_ranks):
                    shards = src.read_rank(step, r)     # resolves refs,
                    nbytes += dst.write_rank(step, r, shards)  # charges bw
                dst.commit(step, n_ranks, m.get("meta"), delta_base=None)
                if self.arbiter is not None:
                    # the demoted bytes cross the shared uplink too: charge
                    # them as one contended flow next to foreground traffic
                    took = self.arbiter.transfer(
                        self.clock.seconds, nbytes,
                        f"demote:{name}->{dst_name}:{step}")
                    self.stats["demotion_transfer_s"] = round(
                        self.stats.get("demotion_transfer_s", 0.0) + took, 6)
                src.delete_step(step, rematerialize=True)
                sizes.pop(step)
                # rematerialization fattened the dependents still on src
                for s in steps:
                    sizes[s] = self._step_stored_bytes(src, s)
                self.stats["demotions"] += 1
                self.stats["demoted_bytes"] += nbytes
                moved.append((step, name, dst_name))
        return moved
