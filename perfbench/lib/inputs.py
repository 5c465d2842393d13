"""The benchmark's inputs, all drawn from ``--seed``: the weights (one
``torch.Generator`` on the device, one call per leaf, stacked layers
included), training batches and prefill waves (a generator per step or wave,
so that any of them can be drawn again on its own). Both the program and the
references take these; neither makes its own.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

Spec = List[Tuple[str, tuple, str, float, int]]
MASK64 = (1 << 64) - 1


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for a stream of ``seed`` (splitmix64 over the keys)."""
    z = seed & MASK64
    for k in keys:
        z = (z ^ ((k + 0x9E3779B97F4A7C15) & MASK64)) & MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        z ^= z >> 31
    return z >> 1


WEIGHTS, BATCH, WAVE, SAMPLE = 1, 2, 3, 4

# The published Mamba-2 layer's initialisation of its decay (A_init_range,
# dt_min, dt_max, dt_init_floor): A uniform in [1, 16], the time step
# log-uniform in [1e-3, 0.1], so that the slow heads carry their state
# from chunk to chunk.
A_RANGE = (1.0, 16.0)
DT_RANGE = (1e-3, 0.1)
DT_FLOOR = 1e-4


def weights(spec: Spec, seed: int, device,
            dtype: torch.dtype) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) in ``spec`` order: each ``normal`` leaf N(0, (scale /
    sqrt(fan_in))^2) and each ``embed`` leaf N(0, scale^2); each ``a_log``
    leaf log A and each ``dt_bias`` leaf softplus^-1(dt), A and dt drawn as
    ``A_RANGE`` and ``DT_RANGE`` say. Each is drawn in float32 by one call on
    the device and cast to ``dtype``; ``zeros`` and ``ones`` as named. The
    same seed gives the same leaves, one at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, WEIGHTS))
    for path, shape, init, scale, fan_in in spec:
        if init == "zeros":
            yield path, torch.zeros(shape, dtype=dtype, device=device)
        elif init == "ones":
            yield path, torch.ones(shape, dtype=dtype, device=device)
        elif init == "a_log":
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            lo, hi = A_RANGE
            yield path, torch.log(lo + (hi - lo) * u).to(dtype)
        elif init == "dt_bias":
            u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
            lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
            dt = torch.exp(lo + (hi - lo) * u).clamp_(min=DT_FLOOR)
            yield path, (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        else:
            x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            x.mul_(scale / math.sqrt(fan_in) if init == "normal" else scale)
            yield path, x.to(dtype)


def weight_dict(spec: Spec, seed: int, device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    return dict(weights(spec, seed, device, dtype))


def batch(seed: int, step: int, rows: int, seq: int, vocab: int, device) -> Dict[str, torch.Tensor]:
    """Training step ``step``'s batch: (rows, seq + 1) uniform token ids;
    tokens are the first ``seq``, labels the last."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, BATCH, step))
    ids = torch.randint(0, vocab, (rows, seq + 1), generator=gen, device=device)
    return {"tokens": ids[:, :-1].contiguous(), "labels": ids[:, 1:].contiguous()}


def wave(seed: int, index: int, rows: int, seq: int, vocab: int, device) -> torch.Tensor:
    """Prefill wave ``index``'s prompts: (rows, seq) uniform token ids."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, WAVE, index))
    return torch.randint(0, vocab, (rows, seq), generator=gen, device=device)
