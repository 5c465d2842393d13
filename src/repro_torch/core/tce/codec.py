"""Checkpoint payload codecs for the persist / restore flows.

Counterpart of ``repro.core.tce.codec``, with the same encodings, the same
demotions and the same payload bytes:

* ``raw``  — bytes as-is (the default; bit-exact, zero transform cost).
* ``zlib`` — lossless DEFLATE, level 1. Bit-exact on decode; falls back to
  ``raw`` when a payload is incompressible.
* ``int8`` — blockwise symmetric absmax quantisation through the port's
  ``quant_blockwise`` kernels: on the card the hand-written CUDA kernels,
  on the CPU their plain version. The payload is the int8 bytes, then the
  float32 scales, with meta ``{block, n_blocks}``. Non-float leaves and
  **lossless-allowlisted paths** take the ``zlib`` route instead.

``encode_shard``/``decode_shard`` are pure byte transforms, numpy in and
numpy out, as in the reference: an ``int8`` leaf goes to ``device``, is
quantised there and comes back. numpy has no bfloat16, so a bf16 leaf is
carried as :data:`BF16`, a 2-byte record holding its bit pattern, which the
checkpoint index names ``bfloat16`` as the reference's ml_dtypes arrays are
named: such a leaf is int8-quantised like any float leaf, and crosses
between the packages in both directions. ``device`` (default ``cuda``) is resolved
only when an ``int8`` leaf is actually encoded or decoded, so ``raw`` and
``zlib`` need no card.
"""
from __future__ import annotations

import fnmatch
import warnings
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.quant_blockwise.ops import dequantize_blockwise, quantize_blockwise

CODECS = ("raw", "zlib", "int8")
INT8_BLOCK = 256
_QUANT_DTYPES = ("float32", "float16", "bfloat16", "float64")
# the bf16 carrier: a record, so that it is never taken for an integer leaf
BF16 = np.dtype([("bfloat16", "<u2")])


def dtype_name(dtype: np.dtype) -> str:
    """A leaf's dtype as the checkpoint index names it."""
    return "bfloat16" if dtype == BF16 else str(dtype)


def np_dtype(name: str) -> np.dtype:
    """Inverse of :func:`dtype_name`."""
    return BF16 if name == "bfloat16" else np.dtype(name)


def is_lossless_path(path: str, patterns: Tuple[str, ...]) -> bool:
    """fnmatch-style allowlist for leaves that must stay bit-exact."""
    return any(fnmatch.fnmatch(path, p) for p in patterns)


def _flat_u8(data: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    with warnings.catch_warnings():      # read-only views: the tensor is only read
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def encode_shard(data: np.ndarray, codec: str, *, lossless: bool = False,
                 block: int = INT8_BLOCK, device=None) -> Tuple[str, np.ndarray, Dict]:
    """Encode one shard's bytes. Returns ``(enc, payload_u8, meta)``.

    ``enc`` is the encoding actually used (int8 demotes to zlib for
    lossless/non-float leaves; zlib demotes to raw when incompressible).
    """
    if codec not in CODECS:
        raise ValueError(f"unknown codec {codec!r} (want one of {CODECS})")
    data = np.ascontiguousarray(data)
    if data.size == 0:
        return "raw", _flat_u8(data), {}
    if codec == "int8" and (lossless or dtype_name(data.dtype) not in _QUANT_DTYPES):
        codec = "zlib"
    if codec == "raw":
        return "raw", _flat_u8(data), {}
    if codec == "zlib":
        comp = zlib.compress(memoryview(data).cast("B"), 1)
        if len(comp) >= data.nbytes:          # incompressible: keep raw
            return "raw", _flat_u8(data), {}
        return "zlib", np.frombuffer(comp, np.uint8), {}
    # int8 blockwise quantisation through the port's kernel (bf16 is read as is)
    dev = resolve_device(device)
    if data.dtype == BF16:
        x = _to_device(data.view(np.int16), dev).view(torch.bfloat16)
    else:
        x = _to_device(data, dev).to(torch.float32)
    q, s = quantize_blockwise(x, block=block)
    q_np, s_np = q.cpu().numpy(), s.cpu().numpy()
    payload = np.concatenate([q_np.reshape(-1).view(np.uint8), s_np.view(np.uint8)])
    return "int8", payload, {"block": block, "n_blocks": int(q_np.shape[0])}


def decode_shard(enc: str, payload: np.ndarray, dtype: str, shape,
                 meta: Optional[Dict] = None, device=None) -> np.ndarray:
    """Inverse of :func:`encode_shard` -> ndarray of ``dtype``/``shape``."""
    meta = meta or {}
    shape = tuple(shape)
    payload = np.asarray(payload, np.uint8)
    dt = np_dtype(dtype)
    if enc == "raw":
        return payload.view(dt).reshape(shape)
    if enc == "zlib":
        rawb = zlib.decompress(payload.tobytes())
        return np.frombuffer(rawb, dt).reshape(shape).copy()
    if enc == "int8":
        block = int(meta["block"])
        n_blocks = int(meta["n_blocks"])
        dev = resolve_device(device)
        q = _to_device(payload[:n_blocks * block].view(np.int8).reshape(n_blocks, block), dev)
        s = _to_device(payload[n_blocks * block:].view(np.float32), dev)
        if dt == BF16:         # q * s in float32, rounded once to bf16, as the reference
            x = dequantize_blockwise(q, s, shape, block=block, dtype=torch.bfloat16)
            return x.view(torch.int16).cpu().numpy().view(BF16)
        x = dequantize_blockwise(q, s, shape, block=block, dtype=torch.float32)
        return x.cpu().numpy().astype(dt, copy=False)
    raise ValueError(f"unknown encoding {enc!r}")
