"""Public wrappers for the blockwise int8 quantise / dequantise kernels.

Counterpart of ``repro.kernels.quant_blockwise.ops`` (and of the 2-D entry
points in ``quant_blockwise.py``), with the same signatures and results. A
tensor on the CPU goes to the plain version (:mod:`.ref`); a tensor on a CUDA
device goes to the hand-written kernels in ``csrc/quant_blockwise.cu``, or
the call raises.

Unlike the reference, which tiles rows by ``min(256, n_blocks)`` and so
asserts on a leaf whose block count is above 256 and not a multiple of it,
these take any block count. ``quantize_blockwise`` zero-pads the flat leaf to
a multiple of the block as the reference does; on the card the kernel reads
the ragged tail as zeros, so no padded copy is made, and
``dequantize_blockwise`` writes only the leaf's own values.

``LAUNCHES`` counts kernel launches per kernel (never the CPU path), so that
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from .. import _build
from .ref import dequantize_reference, quantize_reference

LAUNCHES = {"quantize": 0, "dequantize": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_L = ctypes.c_longlong
_C = ctypes.c_int


def _lib():
    lib = _build.load("quant_blockwise")
    if lib.qb_quantize.argtypes is None:
        lib.qb_quantize.restype = ctypes.c_int
        lib.qb_quantize.argtypes = [_P, _C, _P, _P, _L, _L, _C, _C, _P]
        lib.qb_dequantize.restype = ctypes.c_int
        lib.qb_dequantize.argtypes = [_P, _P, _P, _C, _L, _L, _C, _C, _P]
    return lib


def _check_device(*ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on different devices: {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"quant_blockwise runs on cpu or cuda, not {dev}")
    return dev


def _check_block(block: int) -> None:
    if block <= 0:
        raise ValueError(f"block must be positive, not {block}")


# --------------------------------------------------------------------------- #
# Kernel launches (CUDA tensors only)
# --------------------------------------------------------------------------- #
def _quantize_cuda(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat quantise of contiguous ``x``: (q (n_blocks, block), s (n_blocks,))."""
    if x.dtype not in _DTYPE_CODE:
        x = x.float()
    x = x.contiguous()
    n = x.numel()
    nb = -(-n // block)
    q = torch.empty((nb, block), dtype=torch.int8, device=x.device)
    s = torch.empty((nb,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, s
    rc = _lib().qb_quantize(x.data_ptr(), _DTYPE_CODE[x.dtype], q.data_ptr(), s.data_ptr(),
                            n, nb, block, x.device.index or 0,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {rc}")
    LAUNCHES["quantize"] += 1
    return q, s


def _dequantize_cuda(q: torch.Tensor, s: torch.Tensor, n: int, block: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """Flat dequantise of the first ``n`` values of ``q``: a (n,) tensor."""
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"q must be int8 and s float32, got {q.dtype} and {s.dtype}")
    q, s = q.contiguous(), s.contiguous()
    nb = -(-n // block)
    if q.numel() < nb * block or s.numel() != nb:
        raise ValueError(f"q ({q.numel()} values) and s ({s.numel()} scales) do not hold "
                         f"{n} values in blocks of {block}")
    kdt = dtype if dtype in _DTYPE_CODE else torch.float32
    out = torch.empty((n,), dtype=kdt, device=q.device)
    if n == 0:
        return out.to(dtype)
    rc = _lib().qb_dequantize(q.data_ptr(), s.data_ptr(), out.data_ptr(), _DTYPE_CODE[kdt],
                              n, nb, block, q.device.index or 0,
                              torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dequantize kernel launch failed: CUDA error {rc}")
    LAUNCHES["dequantize"] += 1
    return out if kdt == dtype else out.to(dtype)


# --------------------------------------------------------------------------- #
# 2-D entry points (the Pallas kernels' own signature)
# --------------------------------------------------------------------------- #
def quantize_blockwise_2d(x: torch.Tensor, block: int = 256):
    """x: (n, d), d % block == 0 -> (q int8 (n, d), s f32 (n, d / block))."""
    _check_block(block)
    if x.ndim != 2 or x.shape[1] % block:
        raise ValueError(f"x must be (n, d) with d % {block} == 0, got {tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if _check_device(x).type == "cpu":
        return quantize_reference(x, block)
    n, d = x.shape
    q, s = _quantize_cuda(x, block)
    return q.reshape(n, d), s.reshape(n, d // block)


def dequantize_blockwise_2d(q: torch.Tensor, s: torch.Tensor, block: int = 256,
                            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q: (n, d) int8, s: (n, d / block) f32 -> x (n, d) in ``dtype``."""
    _check_block(block)
    if q.ndim != 2 or q.shape[1] % block or tuple(s.shape) != (q.shape[0], q.shape[1] // block):
        raise ValueError(f"q (n, d) and s (n, d / {block}) expected, got "
                         f"{tuple(q.shape)} and {tuple(s.shape)}")
    if _check_device(q, s).type == "cpu":
        return dequantize_reference(q, s, block, dtype)
    return _dequantize_cuda(q, s, q.numel(), block, dtype).reshape(q.shape)


# --------------------------------------------------------------------------- #
# Any-shape entry points (the codec's layout)
# --------------------------------------------------------------------------- #
def quantize_blockwise(x: torch.Tensor, block: int = 256):
    """Any-shape x -> (q int8 (n_blocks, block), s f32 (n_blocks,)).

    The flat leaf is zero-padded to a multiple of ``block``, as the reference.
    """
    _check_block(block)
    if not x.is_floating_point():
        raise TypeError(f"x must be floating point, got {x.dtype}")
    if _check_device(x).type == "cuda":
        return _quantize_cuda(x.reshape(-1), block)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, s = quantize_reference(flat.reshape(-1, block), block)
    return q, s[:, 0]


def dequantize_blockwise(q: torch.Tensor, s: torch.Tensor, shape: Sequence[int],
                         block: int = 256, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: the first prod(shape) values, reshaped."""
    _check_block(block)
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if q.ndim != 2 or q.shape[1] != block or tuple(s.shape) != (q.shape[0],):
        raise ValueError(f"q (n_blocks, {block}) and s (n_blocks,) expected, got "
                         f"{tuple(q.shape)} and {tuple(s.shape)}")
    if q.shape[0] != -(-n // block):
        raise ValueError(f"{q.shape[0]} blocks of {block} do not hold shape {shape}")
    if _check_device(q, s).type == "cuda":
        return _dequantize_cuda(q, s, n, block, dtype).reshape(shape)
    x = dequantize_reference(q, s[:, None], block, dtype)
    return x.reshape(-1)[:n].reshape(shape)
