"""TrainState: params + optimizer state + step + rng as one tree.

Counterpart of ``repro.train.state``. Everything needed to resume training is
in this tree (plus the data-pipeline state, a step counter). Its flat paths
(``repro_torch.core.tce.engine.flatten_pytree``) are the reference's, so a
checkpoint of either package restores in the other.

``rng`` is an opaque uint32 (2,) leaf, carried bit for bit through
checkpoints. It lives on the CPU: it is read on the host, only to seed
stochastic rounding. The reference draws it from ``jax.random``; the port
derives it from the seed with numpy, so the two hold different bits for the
same seed, as their weights differ.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import ModelConfig, init_params

from .optimizer import AdamConfig, adam_init


class TrainState(NamedTuple):
    step: torch.Tensor       # () int32, on the params' device
    rng: torch.Tensor        # (2,) uint32, on the CPU
    params: Any
    opt: Dict[str, Any]      # {'m': tree, 'v': tree}


def init_rng(seed: int) -> torch.Tensor:
    bits = np.random.Generator(np.random.Philox(key=seed)).integers(
        0, 1 << 32, size=2, dtype=np.uint32)
    return torch.from_numpy(bits)


def init_train_state(cfg: ModelConfig, opt_cfg: AdamConfig, seed: int = 0,
                     device=None) -> TrainState:
    """Random params from ``seed`` on ``device`` (default ``cuda``), zero moments."""
    dev = resolve_device(device)
    params = init_params(cfg, seed=seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      rng=init_rng(seed), params=params,
                      opt=adam_init(params, opt_cfg))
