"""The port's TCE checkpoint engine (``repro.core.tce`` is the reference):
the engine, its per-node caches, the reconciler, the fabric, the stores,
the codecs, the shard layout and the flat train-state view."""
from .engine import (TCEngine, TCEConfig, SaveHandle, PrefetchHandle,
                     flatten_pytree, unflatten_like)
from .cache import CacheServer, EvictionConfig, PutStats
from .codec import BF16, decode_shard, encode_shard, is_lossless_path
from .fastcopy import METER, CopyMeter, crc32_stream
from .store import (ChainIntegrityError, DiskStore, ModeledStore, NASStore,
                    SharedBandwidth, TieredStore)
from .model import tce_theory, TheoryParams
from .sharding import ShardSpec, shard_state, unshard_state, reshard
# the tier vocabulary lives in repro_torch.recovery.tiers (a dependency-free
# leaf); re-exported here because the checkpoint hierarchy is TCE-facing
from repro_torch.recovery.tiers import (Tier, TierTable, default_tiers,
                                        three_leg_tiers)

__all__ = [
    "TCEngine", "TCEConfig", "SaveHandle", "PrefetchHandle", "CacheServer",
    "EvictionConfig", "PutStats", "DiskStore", "NASStore", "ModeledStore",
    "TieredStore", "ChainIntegrityError", "SharedBandwidth",
    "tce_theory", "TheoryParams", "METER", "CopyMeter", "crc32_stream",
    "encode_shard", "decode_shard", "is_lossless_path",
    "ShardSpec", "shard_state", "unshard_state", "reshard",
    "Tier", "TierTable", "default_tiers", "three_leg_tiers",
    "BF16", "flatten_pytree", "unflatten_like",
]
from .patch import transom_protect, start_step, restore_into  # noqa: E402,F401

__all__ += ["transom_protect", "start_step", "restore_into"]
