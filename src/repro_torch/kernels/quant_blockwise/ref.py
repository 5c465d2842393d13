"""Plain PyTorch oracle for blockwise int8 quantisation.

Counterpart of ``repro.kernels.quant_blockwise.ref``. It is what ``ops`` runs
for tensors on the CPU, and what the CUDA kernels are held against, bit for
bit, on the card.

Per block of ``block`` values along the last axis: ``s = max(amax, 1e-12) *
f32(1/127)`` and ``q = clip(round(x / s), -127, 127)`` with a true division
and round half to even. The scale is the one the reference computes when it
is compiled, as its Pallas kernel and its int8 codec always are: XLA turns
the division by the constant 127 into a product with its float32
reciprocal. (The reference's eager jnp oracle divides, and its s then differs
by one ulp in a few percent of blocks; ``tests/test_kernels.py`` compares s
at rtol 1e-6.) Taking the compiled form makes the port's codec payload byte
for byte the reference's. ``x / s`` stays a division in both.

A block that holds a NaN or an infinity gives what the reference gives:
``amax`` propagates NaN (``jnp.max``), so ``s`` is NaN (any NaN) or +inf (an
infinity and no NaN); every ``x / s`` is then 0 or NaN, and the reference's
float-to-int8 conversion turns NaN into 0, so ``q`` is all zeros and the
block dequantises to NaN. (The bits of a NaN scale are not part of the
contract: libraries and the card's arithmetic do not all keep them.)
"""
from __future__ import annotations

import torch

EPS = 1e-12
INV_QMAX = 1.0 / 127.0      # rounded once to float32, as XLA folds it
QMAX = 127.0


def quantize_reference(x: torch.Tensor, block: int = 256):
    """x: (..., d) with d % block == 0 -> (q int8 same shape, s (..., d // block) f32)."""
    *lead, d = x.shape
    if d % block:
        raise ValueError(f"last dim {d} is not a multiple of block {block}")
    xb = x.float().reshape(*lead, d // block, block)
    amax = xb.abs().amax(dim=-1)                          # NaN propagates
    f32 = dict(dtype=torch.float32, device=x.device)
    s = torch.maximum(amax, torch.tensor(EPS, **f32)) * torch.tensor(INV_QMAX, **f32)
    q = torch.round(xb / s[..., None]).clamp(-QMAX, QMAX)
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q.reshape(*lead, d), s


def dequantize_reference(q: torch.Tensor, s: torch.Tensor, block: int = 256,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    *lead, d = q.shape
    qb = q.reshape(*lead, d // block, block).float()
    return (qb * s[..., None]).reshape(*lead, d).to(dtype)
