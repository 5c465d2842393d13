"""Checkpoint shard layout + topology-change resharding.

The port's own copy of ``repro.core.tce.sharding`` (line for line, but for
the dtype name of a bf16 leaf, see ``codec.BF16``), so that both packages cut
a state into the same shards.

The engine stores *named shards*: each leaf of the train state is block-
partitioned along its axis 0 across node ranks (ZeRO-style; leaves whose axis0
does not divide are owned by rank ``hash(path) % n`` — ownership, not
replication, so save volume matches Eq. (1) behaviour). Every shard carries
``(global_shape, axis, start, stop)`` so a checkpoint written on N nodes can be
**resharded** and restored on M != N nodes (elastic shrink/grow).

Zero-copy contract: ``shard_state`` never materialises shard bytes — every
shard is a *view* into the caller's leaf (axis-0 slices of C-contiguous
arrays stay contiguous). The single physical copy in the save path happens
when ``CacheServer.put`` moves these views straight into arena slabs.
"""
from __future__ import annotations

from dataclasses import dataclass, asdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .codec import dtype_name


@dataclass(frozen=True)
class ShardSpec:
    path: str
    global_shape: Tuple[int, ...]
    dtype: str
    axis: int                 # -1 = unsharded (single-owner leaf)
    start: int
    stop: int

    def to_dict(self) -> dict:
        d = asdict(self)
        d["global_shape"] = list(self.global_shape)
        return d

    @staticmethod
    def from_dict(d: dict) -> "ShardSpec":
        return ShardSpec(d["path"], tuple(d["global_shape"]), d["dtype"],
                         d["axis"], d["start"], d["stop"])


Shard = Tuple[ShardSpec, np.ndarray]
NodeShards = Dict[str, Shard]          # path -> (spec, data)


def _owner(path: str, n: int) -> int:
    # stable across processes (Python's str hash is salted per run)
    import zlib
    return zlib.crc32(path.encode()) % n


def shard_state(state: Dict[str, np.ndarray], n_nodes: int
                ) -> List[NodeShards]:
    """Partition a flat state dict across n_nodes. Returns per-node shard maps."""
    nodes: List[NodeShards] = [dict() for _ in range(n_nodes)]
    for path, arr in state.items():
        arr = np.asarray(arr)
        if arr.ndim >= 1 and arr.shape[0] >= n_nodes:
            block = arr.shape[0] // n_nodes
            extra = arr.shape[0] % n_nodes
            start = 0
            for r in range(n_nodes):
                size = block + (1 if r < extra else 0)
                spec = ShardSpec(path, arr.shape, dtype_name(arr.dtype), 0,
                                 start, start + size)
                nodes[r][path] = (spec, arr[start:start + size])
                start += size
        else:
            r = _owner(path, n_nodes)
            spec = ShardSpec(path, arr.shape, dtype_name(arr.dtype), -1, 0, 0)
            nodes[r][path] = (spec, arr)
    return nodes


def unshard_state(node_shards: List[Optional[NodeShards]]
                  ) -> Dict[str, np.ndarray]:
    """Reassemble the full state from (possibly sparse) per-node shard maps."""
    pieces: Dict[str, List[Shard]] = {}
    for shards in node_shards:
        if not shards:
            continue
        for path, (spec, data) in shards.items():
            pieces.setdefault(path, []).append((spec, data))
    out: Dict[str, np.ndarray] = {}
    for path, shards in pieces.items():
        spec0 = shards[0][0]
        if spec0.axis == -1:
            arr = np.asarray(shards[0][1])
            if not arr.flags.writeable:
                # cache-served shards are read-only arena views; the caller
                # owns the restored state, so hand back a private copy (the
                # sharded branch below copies implicitly via concatenate)
                arr = arr.copy()
            out[path] = arr.reshape(spec0.global_shape)
            continue
        shards.sort(key=lambda s: s[0].start)
        covered = 0
        for spec, _ in shards:
            if spec.start != covered:
                raise ValueError(f"{path}: missing shard at row {covered}")
            covered = spec.stop
        if covered != spec0.global_shape[0]:
            raise ValueError(f"{path}: incomplete ({covered}/{spec0.global_shape[0]})")
        out[path] = np.concatenate([d for _, d in shards], axis=0).reshape(
            spec0.global_shape)
    return out



def reshard(node_shards: List[Optional[NodeShards]], new_n: int
            ) -> List[NodeShards]:
    """Re-partition a checkpoint onto a different node count (elastic)."""
    return shard_state(unshard_state(node_shards), new_n)
