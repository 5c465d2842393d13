"""Shared layers: norms, RoPE (split-half, partial, M-RoPE), MLPs, embeddings.

Counterpart of ``repro.models.layers``. All functions are plain functions on
tensors; parameters come from :class:`~repro_torch.models.params.ParamBuilder`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamBuilder, torch_dtype


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def norm_params(pb: ParamBuilder, cfg: ModelConfig):
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": pb.param((cfg.d_model,), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = pb.param((cfg.d_model,), init="zeros")
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Norm computed in float32 and cast back to the input dtype."""
    dt = x.dtype
    x = x.float()
    if cfg.norm == "rmsnorm":
        x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + cfg.norm_eps)
        x = x * p["scale"].float()
    else:  # layernorm / nonparam_ln
        mu = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        if cfg.norm == "layernorm":
            x = x * p["scale"].float() + p["bias"].float()
    return x.to(dt)


# --------------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------------- #
def rope_frequencies(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial_factor: float = 1.0,
               mrope_sections: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — 'split-half' convention.

    x:         (batch, seq, n_heads, d_head)
    positions: (batch, seq) integer positions, or (3, batch, seq) for M-RoPE.

    M-RoPE (Qwen2-VL) assigns the ``rot / 2`` frequencies in bands to the
    (t, h, w) position streams: the first ``mrope_sections[0]`` rotate by
    the t position, the next ``[1]`` by h, the last ``[2]`` by w.
    """
    d_head = x.shape[-1]
    rot = int(d_head * partial_factor)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_frequencies(rot, theta, device=x.device)          # (rot/2,)
    if mrope_sections is not None:
        if sum(mrope_sections) != rot // 2:
            raise ValueError(f"M-RoPE sections {tuple(mrope_sections)} do not sum to "
                             f"{rot // 2}, half the rotated dims")
        # each band's frequencies times its stream's positions, (b, s, rot/2)
        bands = torch.split(inv, list(mrope_sections))
        angles = torch.cat([p.float()[..., None] * f for p, f in zip(positions, bands)], -1)
    else:
        angles = positions.float()[..., None] * inv               # (b, s, rot/2)
    cos = torch.cos(angles)[..., None, :]                         # (b, s, 1, rot/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------- #
# Dense MLP
# --------------------------------------------------------------------------- #
def mlp_params(pb: ParamBuilder, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    p = {"wi": pb.param((cfg.d_model, d_ff))}
    if cfg.activation == "swiglu":
        p["wg"] = pb.param((cfg.d_model, d_ff))
    p["wo"] = pb.param((d_ff, cfg.d_model))
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = torch_dtype(cfg.compute_dtype)
    x = x.to(dt)
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = F.silu(x @ p["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu defaults to tanh
    return h @ p["wo"].to(dt)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embedding_params(pb: ParamBuilder, cfg: ModelConfig):
    p = {"table": pb.param((cfg.vocab_size, cfg.d_model), init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = pb.param((cfg.d_model, cfg.vocab_size))
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Casts the table to the compute dtype before the gather, as the reference.

    The gather is ``index_select``, whose backward on a card has a
    deterministic implementation (``torch.use_deterministic_algorithms``).
    """
    table = p["table"].to(torch_dtype(cfg.compute_dtype))
    return torch.index_select(table, 0, tokens.reshape(-1)).reshape(*tokens.shape, -1)


def lm_logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = torch_dtype(cfg.compute_dtype)
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    return x.to(dt) @ w.to(dt)
