from .config import (EncDecConfig, HybridConfig, MLAConfig, MoEConfig,
                     ModelConfig, SSMConfig, VLMConfig)
from .model import decode_step, forward, init_params, param_shapes
from .blocks import cache_struct, segments
from .params import flatten_params, params_from_flat

__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "HybridConfig",
    "EncDecConfig", "VLMConfig", "init_params", "param_shapes", "forward",
    "decode_step", "cache_struct", "segments", "flatten_params",
    "params_from_flat",
]
