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
MLA layer runs ``chunked_attention`` under every ``attn_impl``: in its
default query blocks in prefill, in one block under autograd (training,
where the blocks would save no memory; the reference's blocks are the same
arithmetic row by row).

``mla_decode`` writes the new token's latents into the cache in place (the
reference returns updated copies), as the port's attention decode does.

Two settings the reference lacks (DeepSeek-V2-Lite's): ``q_lora_rank`` 0
makes the query one product ``x @ w_q`` (d x heads * (nope + rope)) with no
compression and no query norm; ``ModelConfig.rope_scaling`` (YaRN) rotates
``q_pe`` and ``k_pe`` by the blended frequencies of
``layers.rope_frequencies`` and multiplies the softmax scale by
mscale(factor, mscale_all_dim) squared (:func:`softmax_scale`). DeepSeek's
published code rotates interleaved pairs (it de-interleaves q_pe and k_pe
before a split-half rotation); the port's split-half rotation is the same
map on the rope columns of ``w_q`` (or ``w_uq``) and ``w_kr`` permuted once,
so under random weights the two are one model.

The reconstructing forward records the spans ``mla.project`` (``tokens``,
``q_lora_rank``, ``rope``: "yarn" or "plain"; the products, the kv norm and
the rope), ``mla.attend`` (``tokens``, ``qk_dim``, ``v_dim``, ``scale``) and
``mla.out`` (the output product) (``repro_torch.obs``). Their backward runs
outside them, under the train step's ``train.backward``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch import obs
from repro_torch.kernels.flash_attention.ref import NEG_INF

from .attention import chunked_attention
from .config import ModelConfig
from .layers import apply_rope, yarn_mscale
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
    if m.q_lora_rank:
        query = {
            "w_dq": pb.param((d, m.q_lora_rank), ("embed", "lora")),
            "q_scale": pb.param((m.q_lora_rank,), ("lora",), init="ones"),
            "w_uq": pb.param((m.q_lora_rank, nh * qk), ("lora", "heads")),
        }
    else:
        query = {"w_q": pb.param((d, nh * qk), ("embed", "heads"))}
    return {
        **query,
        "w_dkv": pb.param((d, m.kv_lora_rank), ("embed", "lora")),
        "kv_scale": pb.param((m.kv_lora_rank,), ("lora",), init="ones"),
        "w_kr": pb.param((d, m.qk_rope_dim), ("embed", "lora")),
        "w_uk": pb.param((m.kv_lora_rank, nh * m.qk_nope_dim), ("lora", "heads")),
        "w_uv": pb.param((m.kv_lora_rank, nh * m.v_head_dim), ("lora", "heads")),
        "w_o": pb.param((nh * m.v_head_dim, d), ("heads", "embed")),
    }


def softmax_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope head dims), times mscale(factor, mscale_all_dim)
    squared under YaRN with an ``mscale_all_dim`` (DeepSeek-V2's
    ``softmax_scale``)."""
    m, rs = cfg.mla, cfg.rope_scaling
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    if rs is not None and rs.mscale_all_dim:
        scale *= yarn_mscale(rs.factor, rs.mscale_all_dim) ** 2
    return scale


def _latents(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """(q_nope, q_pe, ckv, k_pe); ckv and k_pe are what decode caches."""
    m = cfg.mla
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    x = x.to(dt)
    if m.q_lora_rank:
        cq = _rms(x @ p["w_dq"].to(dt)) * p["q_scale"].to(dt)
        q = cq @ p["w_uq"].to(dt)
    else:
        q = x @ p["w_q"].to(dt)
    q = q.reshape(b, s, cfg.n_heads, m.qk_nope_dim + m.qk_rope_dim)
    ckv = _rms(x @ p["w_dkv"].to(dt)) * p["kv_scale"].to(dt)
    # q_pe and k_pe (one more head) in one rotation: half the launches of two
    pe = torch.cat([q[..., m.qk_nope_dim:], (x @ p["w_kr"].to(dt))[:, :, None, :]], dim=2)
    pe = apply_rope(pe, positions, cfg.rope_theta, scaling=cfg.rope_scaling)
    return q[..., :m.qk_nope_dim], pe[:, :, :-1], ckv, pe[:, :, -1]


def mla_forward(p, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor) -> Tuple[torch.Tensor, dict]:
    """Training / prefill (reconstructing form). Returns (y, latent cache)."""
    m = cfg.mla
    dt = torch_dtype(cfg.compute_dtype)
    b, s, _ = x.shape
    nh = cfg.n_heads
    rope = "plain" if cfg.rope_scaling is None else "yarn"
    with obs.span("mla.project", tokens=b * s, q_lora_rank=m.q_lora_rank, rope=rope):
        q_nope, q_pe, ckv, k_pe = _latents(p, x, cfg, positions)
        k_nope = (ckv @ p["w_uk"].to(dt)).reshape(b, s, nh, m.qk_nope_dim)
        v = (ckv @ p["w_uv"].to(dt)).reshape(b, s, nh, m.v_head_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(q_pe.shape)], dim=-1)
    scale = softmax_scale(cfg)
    # under autograd every query block's scores are kept for the backward, so
    # blocks save no memory in training and each costs ~40 launches forward
    # and more backward: one block there (prefill keeps the default blocks)
    q_block = s if torch.is_grad_enabled() and q.requires_grad else None
    with obs.span("mla.attend", tokens=b * s, qk_dim=q.shape[-1], v_dim=m.v_head_dim,
                  scale=scale):
        # without YaRN, chunked_attention's own 1/sqrt(d), bit for bit as before
        o = chunked_attention(q, k, v, causal=True, q_block=q_block,
                              scale=scale if cfg.rope_scaling is not None else None)
    with obs.span("mla.out", tokens=b * s):
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
    scale = softmax_scale(cfg)
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
