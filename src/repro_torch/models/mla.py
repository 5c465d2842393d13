"""Multi-head Latent Attention (DeepSeek-V2/V3).

Counterpart of ``repro.models.mla``. Training and prefill use the
reconstructing form (decompress K and V per token); decode uses the
*absorbed* form: W_uk is folded into the query and W_uv into the output, so
the cache holds only the ``kv_lora_rank + qk_rope_dim`` latent per token.

The prefill attends with q.k at head dim ``qk_nope_dim + qk_rope_dim`` (192
in DeepSeek-V3) and v at ``v_head_dim`` (128), through
:func:`~repro_torch.models.attention.chunked_attention`, as the reference
does; no Pallas kernel of the reference computes it, and the port's
flash-attention kernel takes equal q, k and v head dims of 64 or 128. So an
MLA layer runs ``chunked_attention`` under every ``attn_impl``.

``mla_decode`` writes the new token's latents into the cache in place (the
reference returns updated copies), as the port's attention decode does.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF

from .attention import chunked_attention
from .config import ModelConfig
from .layers import apply_rope
from .params import ParamBuilder, torch_dtype


def _rms(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x.to(dt)


def mla_params(pb: ParamBuilder, cfg: ModelConfig):
    m = cfg.mla
    d, nh = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    return {
        "w_dq": pb.param((d, m.q_lora_rank)),
        "q_scale": pb.param((m.q_lora_rank,), init="ones"),
        "w_uq": pb.param((m.q_lora_rank, nh * qk)),
        "w_dkv": pb.param((d, m.kv_lora_rank)),
        "kv_scale": pb.param((m.kv_lora_rank,), init="ones"),
        "w_kr": pb.param((d, m.qk_rope_dim)),
        "w_uk": pb.param((m.kv_lora_rank, nh * m.qk_nope_dim)),
        "w_uv": pb.param((m.kv_lora_rank, nh * m.v_head_dim)),
        "w_o": pb.param((nh * m.v_head_dim, d)),
    }


def _latents(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope, q_pe, ckv, k_pe); ckv and k_pe are what decode caches."""
    m = cfg.mla
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    x = x.to(dt)
    cq = _rms(x @ p["w_dq"].to(dt)) * p["q_scale"].to(dt)
    q = (cq @ p["w_uq"].to(dt)).reshape(b, s, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    ckv = _rms(x @ p["w_dkv"].to(dt)) * p["kv_scale"].to(dt)
    k_pe = apply_rope((x @ p["w_kr"].to(dt))[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_pe, ckv, k_pe


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Training / prefill (reconstructing form). Returns (y, latent cache)."""
    m = cfg.mla
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    nh = cfg.n_heads
    q_nope, q_pe, ckv, k_pe = _latents(p, x, cfg, positions)
    k_nope = (ckv @ p["w_uk"].to(dt)).reshape(b, s, nh, m.qk_nope_dim)
    v = (ckv @ p["w_uv"].to(dt)).reshape(b, s, nh, m.v_head_dim)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(q_pe.shape)], dim=-1)
    o = chunked_attention(q, k, v, causal=True)
    y = o.reshape(b, s, -1) @ p["w_o"].to(dt)
    return y, {"ckv": ckv, "kpe": k_pe}


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache_ckv: torch.Tensor,
               cache_kpe: torch.Tensor, pos: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed one-step decode.

    cache_ckv: (B, T, kv_lora_rank); cache_kpe: (B, T, qk_rope_dim); pos: (B,).
    Scores are float32 products of the latents (the reference's
    ``preferred_element_type=f32``).
    """
    m = cfg.mla
    dt = torch_dtype(cfg.compute_dtype)
    b = x.shape[0]
    nh = cfg.n_heads
    q_nope, q_pe, ckv, k_pe = _latents(p, x, cfg, pos[:, None])

    bidx = torch.arange(b, device=x.device)
    cache_ckv[bidx, pos] = ckv[:, 0].to(cache_ckv.dtype)
    cache_kpe[bidx, pos] = k_pe[:, 0].to(cache_kpe.dtype)

    # absorb W_uk into q: (b, nh, dn) x (kvr, nh, dn) -> (b, nh, kvr)
    w_uk = p["w_uk"].to(dt).reshape(m.kv_lora_rank, nh, m.qk_nope_dim)
    q_abs = torch.einsum("bnd,rnd->bnr", q_nope[:, 0], w_uk)
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    scores = (torch.einsum("bnr,btr->bnt", q_abs.float(), cache_ckv.float())
              + torch.einsum("bnr,btr->bnt", q_pe[:, 0].float(), cache_kpe.float())) * scale
    t = cache_ckv.shape[1]
    mask = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(mask[:, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)

    ctx = torch.einsum("bnt,btr->bnr", w, cache_ckv)                   # (b, nh, kvr)
    w_uv = p["w_uv"].to(dt).reshape(m.kv_lora_rank, nh, m.v_head_dim)
    o = torch.einsum("bnr,rnv->bnv", ctx, w_uv)                       # (b, nh, dv)
    y = o.reshape(b, -1) @ p["w_o"].to(dt)
    return y[:, None, :], cache_ckv, cache_kpe
