"""Serving steps: batched prefill and single-token decode with a KV cache.

Counterpart of ``repro.serve.engine``. Serving runs parameters in the compute
dtype (cast once at load). ``decode_fn`` updates the cache (attention k, v;
SSM conv tail and state) in place, as the reference's serve loop donates it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import blocks
from repro_torch.models import model as model_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import torch_dtype, tree_map


def serve_params_cast(params, cfg: ModelConfig):
    dt = torch_dtype(cfg.compute_dtype)
    return tree_map(lambda p: p.to(dt) if p.is_floating_point() else p, params)


def prefill_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
               attn_impl: str = "kernel"):
    """Prefill: full-sequence forward, returns (last-token logits, cache)."""
    logits, cache, _, _ = model_mod.forward(params, cfg, batch, mode="prefill",
                                            attn_impl=attn_impl)
    return logits[:, -1], cache


def decode_fn(params, cfg: ModelConfig, token: torch.Tensor, cache,
              pos: torch.Tensor):
    """One decode step: (b,) token ids + cache -> (logits, cache)."""
    return model_mod.decode_step(params, cfg, token, cache, pos)


def pad_cache(cfg: ModelConfig, cache, batch: int, cache_len: int):
    """Copy a prefill cache into the front of a zero cache of ``cache_len``
    positions (the reference's ``put`` into ``cache_struct(mode="zeros")``).

    A leaf whose shape does not grow with the length (an SSM layer's conv
    tail and state, the encoder-decoder's ``ek`` / ``ev`` over the encoder's
    frames) is taken as it is, with no copy.
    """
    enc_len = cfg.encdec.enc_len if cfg.encdec is not None else None
    shapes = blocks.cache_struct(cfg, batch, cache_len, enc_len=enc_len, device="meta")

    def put(want, src):
        if src.shape == want.shape:
            return src.to(want.dtype)
        dst = torch.zeros(want.shape, dtype=want.dtype, device=src.device)
        dst[tuple(slice(0, d) for d in src.shape)] = src.to(want.dtype)
        return dst

    return tree_map(put, shapes, cache)


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                    steps: int, cache_len: Optional[int] = None):
    """Reference generation loop (prefill + ``steps`` greedy decodes).

    Used by tests; the serve CLI drives prefill_fn/decode_fn directly. The
    batch's extras (``enc_embeds``, ``vision_embeds``, ``positions``) go to
    the prefill.
    """
    b, s = batch["tokens"].shape
    cache_len = cache_len or (s + steps)
    logits, cache = prefill_fn(params, cfg, batch)
    cache = pad_cache(cfg, cache, b, cache_len)
    tok = torch.argmax(logits, dim=-1)
    out = [tok]
    pos = torch.full((b,), s, dtype=torch.long, device=tok.device)
    for _ in range(steps - 1):
        logits, cache = decode_fn(params, cfg, tok, cache, pos)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
