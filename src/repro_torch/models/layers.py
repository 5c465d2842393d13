"""Shared layers: norms, RoPE (split-half, partial, M-RoPE, YaRN), MLPs, embeddings.

Counterpart of ``repro.models.layers``. All functions are plain functions on
tensors; parameters come from :class:`~repro_torch.models.params.ParamBuilder`.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig, RopeScaling
from .params import ParamBuilder, torch_dtype


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #
def norm_params(pb: ParamBuilder, cfg: ModelConfig):
    if cfg.norm == "nonparam_ln":
        return {}
    p = {"scale": pb.param((cfg.d_model,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        p["bias"] = pb.param((cfg.d_model,), ("embed",), init="zeros")
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
def yarn_mscale(factor: float, mscale: float) -> float:
    """DeepSeek-V2's ``yarn_get_mscale``: 0.1 mscale ln(factor) + 1, and 1
    where the factor does not stretch."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(dim: int, theta: float, rs: RopeScaling) -> Tuple[int, int]:
    """DeepSeek-V2's ``yarn_find_correction_range``: the rotary indices
    (of ``dim / 2``) below which a frequency turns more than ``beta_fast``
    times over the original context (kept as trained) and above which
    fewer than ``beta_slow`` times (interpolated), clamped to [0, dim - 1]."""
    def index(rotations: float) -> float:
        return (dim * math.log(rs.original_max_positions / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))

    return max(math.floor(index(rs.beta_fast)), 0), min(math.ceil(index(rs.beta_slow)), dim - 1)


def rope_frequencies(dim: int, theta: float, device=None,
                     scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """The ``dim / 2`` inverse frequencies; under YaRN (``scaling``) each is
    blended from its original (``freq_extra``) and its interpolated value
    (over ``factor``, ``freq_inter``) by a linear ramp over
    :func:`yarn_correction_range`, as DeepSeek-V2's
    ``DeepseekV2YarnRotaryEmbedding``."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    freq_extra = 1.0 / (theta ** exps)
    if scaling is None:
        return freq_extra
    freq_inter = 1.0 / (scaling.factor * theta ** exps)
    low, high = yarn_correction_range(dim, theta, scaling)
    span = high - low if high > low else 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / span, 0, 1)
    return freq_inter * ramp + freq_extra * (1 - ramp)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               partial_factor: float = 1.0,
               mrope_sections: Optional[Tuple[int, int, int]] = None,
               scaling: Optional[RopeScaling] = None) -> torch.Tensor:
    """Rotate pairs (x[..., :d/2], x[..., d/2:]) — 'split-half' convention.

    x:         (batch, seq, n_heads, d_head)
    positions: (batch, seq) integer positions, or (3, batch, seq) for M-RoPE.

    M-RoPE (Qwen2-VL) assigns the ``rot / 2`` frequencies in bands to the
    (t, h, w) position streams: the first ``mrope_sections[0]`` rotate by
    the t position, the next ``[1]`` by h, the last ``[2]`` by w.

    ``scaling`` (YaRN) takes :func:`rope_frequencies`' blended frequencies
    and multiplies cos and sin by mscale(factor, mscale) / mscale(factor,
    mscale_all_dim) (1 where the two are equal, as in DeepSeek-V2).
    """
    d_head = x.shape[-1]
    rot = int(d_head * partial_factor)
    rot -= rot % 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    inv = rope_frequencies(rot, theta, device=x.device, scaling=scaling)   # (rot/2,)
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
    if scaling is not None:
        gain = (yarn_mscale(scaling.factor, scaling.mscale)
                / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        if gain != 1.0:
            cos, sin = cos * gain, sin * gain
    x1, x2 = torch.chunk(x_rot.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


# --------------------------------------------------------------------------- #
# Dense MLP
# --------------------------------------------------------------------------- #
def mlp_params(pb: ParamBuilder, cfg: ModelConfig, d_ff: Optional[int] = None):
    d_ff = d_ff or cfg.d_ff
    p = {"wi": pb.param((cfg.d_model, d_ff), ("embed", "mlp"))}
    if cfg.activation == "swiglu":
        p["wg"] = pb.param((cfg.d_model, d_ff), ("embed", "mlp"))
    p["wo"] = pb.param((d_ff, cfg.d_model), ("mlp", "embed"))
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
    p = {"table": pb.param((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                           init="embed", scale=0.02)}
    if not cfg.tie_embeddings:
        p["head"] = pb.param((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
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
