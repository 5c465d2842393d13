"""Abstract input stand-ins per (arch x shape) cell.

Counterpart of ``repro.launch.specs``: meta tensors (shapes and dtypes, no
allocation) and their logical axes, which the dry run counts against. Stub
frontends (whisper frames, qwen2-vl patches) are precomputed embeddings, as
in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.models import ModelConfig, blocks
from repro_torch.models.params import torch_dtype

I32 = torch.int32


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_specs(cfg: ModelConfig, b: int, s: int, with_labels: bool):
    shapes: Dict[str, Any] = {"tokens": _meta((b, s), I32)}
    axes: Dict[str, Any] = {"tokens": ("batch", None)}
    if with_labels:
        shapes["labels"] = _meta((b, s), I32)
        axes["labels"] = ("batch", None)
    dt = torch_dtype(cfg.compute_dtype)
    if cfg.family == "encdec":
        shapes["enc_embeds"] = _meta((b, cfg.encdec.enc_len, cfg.d_model), dt)
        axes["enc_embeds"] = ("batch", None, None)
    if cfg.family == "vlm":
        nv = min(cfg.vlm.n_vision_tokens, s)
        shapes["vision_embeds"] = _meta((b, nv, cfg.d_model), dt)
        axes["vision_embeds"] = ("batch", None, None)
    return shapes, axes


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (abstract_inputs, logical_axes) for the cell's step function.

    train   -> {'batch': ...}
    prefill -> {'batch': ...}
    decode  -> {'token', 'cache', 'pos'}
    """
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        shapes, axes = _batch_specs(cfg, b, s, with_labels=(shape.kind == "train"))
        return {"batch": shapes}, {"batch": axes}
    # decode: one new token against a cache of length s
    enc_len = cfg.encdec.enc_len if cfg.encdec else None
    cache = blocks.cache_struct(cfg, b, s, enc_len=enc_len, device="meta")
    cache_axes = blocks.cache_struct(cfg, b, s, enc_len=enc_len, mode="axes")
    return ({"token": _meta((b,), I32), "cache": cache, "pos": _meta((b,), I32)},
            {"token": ("batch",), "cache": cache_axes, "pos": ("batch",)})
