"""The port's TCE checkpoint datapath: codec, store, sharding and the flat
train-state view (``repro.core.tce`` is the reference)."""
from .codec import BF16, decode_shard, encode_shard, is_lossless_path
from .engine import flatten_pytree, unflatten_like
from .fastcopy import crc32_stream
from .sharding import ShardSpec, shard_state, unshard_state
from .store import DiskStore

__all__ = [
    "DiskStore", "crc32_stream", "encode_shard", "decode_shard", "is_lossless_path",
    "BF16", "flatten_pytree", "unflatten_like", "ShardSpec", "shard_state", "unshard_state",
]
