"""GQA attention: prefill through the flash-attention kernel, training through
exact chunked attention, and the single-token decode step.

Counterpart of ``repro.models.attention``. Layouts are the reference's:
q (B, S, H, D), k and v (B, T, KH, D).

``attention_forward`` takes ``attn_impl``:

* ``"kernel"`` — the hand-written CUDA flash-attention kernel on a card (its
  plain version for tensors on the CPU). Forward only: it raises under
  autograd, as the reference's Pallas attention has no VJP. Serving uses it.
* ``"chunked"`` — :func:`chunked_attention`, exact attention over query
  blocks in plain torch ops, differentiable. Training uses it, as the
  reference trains with ``attn_impl="xla"`` (the same function, left to XLA);
  ``"xla"`` is accepted as its other name.
* ``"plain"`` — the flash kernel's plain version everywhere, so that the card
  can hold the kernel against it; nothing on a main path passes it.

The encoder-decoder family's cross attention (:func:`cross_attention_forward`,
against :func:`project_enc_kv`'s encoder k and v) takes ``attn_impl`` too.

Decode is plain torch ops, as the reference computes it with jnp einsums and
no Pallas kernel. ``attention_decode`` writes the new token into the cache
in place (the reference returns updated copies; in place saves a copy of the
whole cache per step).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_reference

from .config import ModelConfig
from .layers import apply_rope
from .params import ParamBuilder, torch_dtype

ATTN_IMPLS = ("kernel", "chunked", "plain")
ATTN_ALIASES = {"xla": "chunked"}        # the reference's name for the same math


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def attn_params(pb: ParamBuilder, cfg: ModelConfig):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": pb.param((d, h * dh), ("embed", "heads")),
        "wk": pb.param((d, kh * dh), ("embed", "kv_heads")),
        "wv": pb.param((d, kh * dh), ("embed", "kv_heads")),
        "wo": pb.param((h * dh, d), ("heads", "embed")),
    }
    if cfg.use_bias:
        p["bq"] = pb.param((h * dh,), ("heads",), init="zeros")
        p["bk"] = pb.param((kh * dh,), ("kv_heads",), init="zeros")
        p["bv"] = pb.param((kh * dh,), ("kv_heads",), init="zeros")
        p["bo"] = pb.param((d,), ("embed",), init="zeros")
    return p


# --------------------------------------------------------------------------- #
# Core attention math
# --------------------------------------------------------------------------- #
def _pick_q_block(seq: int) -> int:
    for blk in (512, 256, 128, 64, 32, 16, 8, 4, 2, 1):
        if seq % blk == 0 and blk <= seq:
            return blk
    return 1


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, q_block: Optional[int] = None) -> torch.Tensor:
    """Exact attention, a loop over query blocks.

    q: (B, S, H, D);  k, v: (B, T, KH, D) with H = KH * rep. (The reference's
    ``kv_len`` masks a decode cache; the port decodes with
    :func:`decode_attention`, so no caller needs it.) Scores and softmax are float32 (the reference's
    ``preferred_element_type=f32``: bf16 operands are widened, so each product
    is exact); the weights are cast to v's dtype before P.V, as the reference.
    """
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = 1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32, device=q.device))
    q_block = q_block or _pick_q_block(s)
    n_blocks = s // q_block
    qb = q.reshape(b, n_blocks, q_block, kh, rep, d)
    kf = k.float()
    t_idx = torch.arange(t, device=q.device)
    outs = []
    for i in range(n_blocks):
        scores = torch.einsum("bqkrd,btkd->bkrqt", qb[:, i].float(), kf) * scale
        if causal:
            q_idx = i * q_block + torch.arange(q_block, device=q.device)
            mask = q_idx[:, None] >= t_idx[None, :]
            scores = torch.where(mask, scores, NEG_INF)
        w = torch.softmax(scores, dim=-1)
        outs.append(torch.einsum("bkrqt,btkd->bqkrd", w.to(v.dtype), v))
    return torch.stack(outs, dim=1).reshape(b, s, h, v.shape[-1])


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


def _attend(q, k, v, causal: bool, attn_impl: str) -> torch.Tensor:
    """Attention of q against k, v by ``attn_impl`` (module docstring)."""
    attn_impl = ATTN_ALIASES.get(attn_impl, attn_impl)
    if attn_impl == "kernel":
        return fa_ops.flash_attention(q, k, v, causal=causal)
    if attn_impl == "chunked":
        return chunked_attention(q, k, v, causal)
    if attn_impl == "plain":
        return attention_reference(q, k, v, causal=causal)
    raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, not {attn_impl!r}")


def attention_forward(p, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, causal: bool = True,
                      mrope_sections=None, use_rope: bool = True,
                      attn_impl: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Training / prefill forward. Returns (y, kv) — kv feeds the cache.

    ``positions`` is (b, s), or (3, b, s) with ``mrope_sections`` (M-RoPE).
    """
    q, k, v = _project_qkv(p, x, cfg)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.partial_rotary_factor, mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.partial_rotary_factor, mrope_sections)
    o = _attend(q, k, v, causal, attn_impl)
    return _out_proj(p, o, cfg), {"k": k, "v": v}


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     pos: torch.Tensor, mrope_sections=None,
                     use_rope: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. cache_k/v: (B, T, KH, D); pos: (B,) write index.

    Writes the new k, v into the caches in place and returns (y, cache_k, cache_v).
    Under M-RoPE the token takes ``pos`` in all three streams, as the reference.
    """
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg)                            # s == 1
    if use_rope:
        pos2d = pos[:, None]                                     # (b, 1)
        if mrope_sections is not None:
            pos2d = pos2d[None].expand(3, b, 1)
        q = apply_rope(q, pos2d, cfg.rope_theta, cfg.partial_rotary_factor, mrope_sections)
        k = apply_rope(k, pos2d, cfg.rope_theta, cfg.partial_rotary_factor, mrope_sections)
    bidx = torch.arange(b, device=x.device)
    cache_k[bidx, pos] = k[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos] = v[:, 0].to(cache_v.dtype)
    o = decode_attention(q, cache_k, cache_v, pos)
    return _out_proj(p, o, cfg), cache_k, cache_v


def cross_attention_forward(p, x: torch.Tensor, enc_kv: Tuple[torch.Tensor, torch.Tensor],
                            cfg: ModelConfig, attn_impl: str = "kernel") -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (no RoPE, not causal).

    The reference always runs ``chunked_attention`` here; the port takes
    ``attn_impl`` as for self-attention, so a kernel prefill sends it to the
    flash-attention kernel (S decoder rows against T encoder rows).
    """
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    q = x.to(dt) @ p["wq"].to(dt)
    if cfg.use_bias:
        q = q + p["bq"].to(dt)
    k, v = enc_kv
    o = _attend(q.reshape(b, s, cfg.n_heads, cfg.d_head), k, v, False, attn_impl)
    return _out_proj(p, o, cfg)


def project_enc_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """Cross-attention K/V from the encoder output, each (B, T, KH, D) and
    contiguous (what the flash-attention kernel reads)."""
    dt = torch_dtype(cfg.compute_dtype)
    b, t, _ = enc_out.shape
    x = enc_out.to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.use_bias:
        k, v = k + p["bk"].to(dt), v + p["bv"].to(dt)
    return (k.reshape(b, t, cfg.n_kv_heads, cfg.d_head),
            v.reshape(b, t, cfg.n_kv_heads, cfg.d_head))
