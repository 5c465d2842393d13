"""GQA attention: prefill/train through the flash-attention kernel, and the
single-token decode step.

Counterpart of ``repro.models.attention``. Layouts are the reference's:
q (B, S, H, D), k and v (B, T, KH, D).

``attention_forward`` takes ``attn_impl="kernel"`` (the hand-written CUDA
kernel on a card; its plain version for tensors on the CPU) or ``"plain"``,
which forces the plain version everywhere. The plain path exists so that the
card can hold the kernel against it; nothing on the main path passes it.

Decode is plain torch ops, as the reference computes it with jnp einsums and
no Pallas kernel. ``attention_decode`` writes the new token into the cache
in place (the reference returns updated copies; in place saves a copy of the
whole cache per step).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_reference

from .config import ModelConfig
from .layers import apply_rope
from .params import ParamBuilder, torch_dtype

ATTN_IMPLS = ("kernel", "plain")


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def attn_params(pb: ParamBuilder, cfg: ModelConfig):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": pb.param((d, h * dh)),
        "wk": pb.param((d, kh * dh)),
        "wv": pb.param((d, kh * dh)),
        "wo": pb.param((h * dh, d)),
    }
    if cfg.use_bias:
        p["bq"] = pb.param((h * dh,), init="zeros")
        p["bk"] = pb.param((kh * dh,), init="zeros")
        p["bv"] = pb.param((kh * dh,), init="zeros")
        p["bo"] = pb.param((d,), init="zeros")
    return p


# --------------------------------------------------------------------------- #
# Core attention math
# --------------------------------------------------------------------------- #
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """Single-step decode. q: (B, 1, H, D); k, v: (B, T, KH, D); pos: (B,)."""
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    qh = q.reshape(b, kh, rep, d)
    scores = torch.einsum("bkrd,btkd->bkrt", qh.float(), k.float())
    scores = scores * torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    mask = torch.arange(t, device=q.device)[None, :] <= pos[:, None]      # (b, t)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkrt,btkd->bkrd", w.to(v.dtype), v)
    return o.reshape(b, 1, h, d)


# --------------------------------------------------------------------------- #
# Full module forward
# --------------------------------------------------------------------------- #
def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig):
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    h, kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    x = x.to(dt)
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.use_bias:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return q.reshape(b, s, h, dh), k.reshape(b, s, kh, dh), v.reshape(b, s, kh, dh)


def _out_proj(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = torch_dtype(cfg.compute_dtype)
    b, s = o.shape[:2]
    y = o.reshape(b, s, -1).to(dt) @ p["wo"].to(dt)
    if cfg.use_bias:
        y = y + p["bo"].to(dt)
    return y


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True,
                      use_rope: bool = True,
                      attn_impl: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Training / prefill forward. Returns (y, kv) — kv feeds the cache."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, not {attn_impl!r}")
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor)
    if attn_impl == "kernel":
        o = fa_ops.flash_attention(q, k, v, causal=causal)
    else:
        o = attention_reference(q, k, v, causal=causal)
    return _out_proj(p, o, cfg), {"k": k, "v": v}


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor,
                     use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. cache_k/v: (B, T, KH, D); pos: (B,) write index.

    Writes the new k, v into the caches in place and returns (y, cache_k, cache_v).
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)                            # s == 1
    if use_rope:
        pos2d = pos[:, None]                                     # (b, 1)
        q = apply_rope(q, pos2d, cfg.rope_theta, cfg.partial_rotary_factor)
        k = apply_rope(k, pos2d, cfg.rope_theta, cfg.partial_rotary_factor)
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos] = v[:, 0].to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, pos)
    return _out_proj(p, o, cfg), cache_k, cache_v
