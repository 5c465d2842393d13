"""Persistent checkpoint store: ``DiskStore``.

Counterpart of ``DiskStore`` in ``repro.core.tce.store``, with the same
directory layout (``step_*/rank_*/shard_*.bin`` + ``index.json``, a manifest
written last with an atomic rename), the same index entries (stored-payload
crc32, raw-content digest, delta ``ref_step`` entries, ``enc`` and ``meta``),
and the same delta-chain rules, so a checkpoint written by either package
reads in the other. The only addition is ``device``, passed down to the
codec: where an ``int8`` leaf is quantised or dequantised (default ``cuda``).

The reference's ``SharedBandwidth``, ``NASStore``, ``ModeledStore`` and
``TieredStore``, its per-job namespaces and its chain-safe step deletion
wait for the port of the TCE engine, which calls them.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .codec import decode_shard, dtype_name, encode_shard, is_lossless_path
from .fastcopy import crc32_stream
from .sharding import NodeShards, ShardSpec


class DiskStore:
    """step -> {rank -> NodeShards}; manifest written last, atomically.

    ``device`` is where ``int8`` leaves are (de)quantised.
    """

    def __init__(self, root: str, *, device=None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.device = device

    # -- paths ---------------------------------------------------------- #
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _rank_dir(self, step: int, rank: int) -> Path:
        return self._step_dir(step) / f"rank_{rank:05d}"

    def _manifest(self, step: int) -> Path:
        return self._step_dir(step) / "manifest.json"

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
        """
        d = self._rank_dir(step, rank)
        d.mkdir(parents=True, exist_ok=True)
        refs = refs or {}
        stored_total = 0
        index = []
        for i, (path, (spec, data)) in enumerate(sorted(shards.items())):
            data = np.ascontiguousarray(data)
            ent = {"spec": spec.to_dict(), "dtype": dtype_name(data.dtype),
                   "shape": list(data.shape), "nbytes_raw": int(data.nbytes)}
            if path in refs:
                home_step, digest = refs[path]
                ent.update({"ref_step": int(home_step), "digest": int(digest)})
                index.append(ent)
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
                os.fsync(f.fileno())
            os.replace(tmp, d / fname)   # atomic
            stored_total += payload.nbytes
            digest = (digests[path] if digests and path in digests
                      else crc32_stream(data))
            ent.update({"file": fname, "enc": enc, "meta": meta,
                        "crc32": int(crc32_stream(payload)),
                        "digest": int(digest),
                        "nbytes_stored": int(payload.nbytes)})
            index.append(ent)
        tmp = d / "index.json.tmp"
        tmp.write_text(json.dumps(index))
        os.replace(tmp, d / "index.json")
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
        """Read one rank's shards, resolving delta refs to the step whose
        rank dir holds each leaf's file."""
        index = self.rank_index(step, rank)
        out: NodeShards = {}
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
            if verify and int(crc32_stream(payload)) != resolved["crc32"]:
                raise IOError(f"checksum mismatch for {spec.path} in rank {rank}")
            data = decode_shard(resolved.get("enc", "raw"), payload,
                                ent["dtype"], ent["shape"],
                                resolved.get("meta"), device=self.device)
            out[spec.path] = (spec, data)
        return out

    def read_all(self, step: int) -> List[NodeShards]:
        m = self.manifest(step)
        return [self.read_rank(step, r) for r in range(m["n_ranks"])]
