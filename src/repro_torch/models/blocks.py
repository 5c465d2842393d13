"""Decoder block assembly over stacked (leading 'layers' axis) parameters.

Counterpart of ``repro.models.blocks``. An architecture is decomposed into
*segments*: maximal runs of layers whose (mixer, mlp) pattern repeats with a
fixed period, with every leaf stacked over a leading ``n_steps`` axis, as in
the reference (whose checkpoints and caches keep that axis). Where the
reference runs a segment as one ``lax.scan``, the port runs a Python loop over
the leading axis; ``scan_layers`` and ``remat`` change nothing here.

Ported so far: the dense family (attention + dense MLP), as in llama3.
``layer_spec`` raises ``NotImplementedError`` for MLA, SSM and MoE layers
(and ``model.model_params`` for the encdec and vlm families).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn_mod
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, mlp_params, norm_params
from .params import ParamBuilder, stacked, torch_dtype, tree_map


@dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | mla | ssm
    mlp: str           # dense | moe | none


@dataclass(frozen=True)
class Segment:
    name: str
    n_steps: int
    specs: Tuple[LayerSpec, ...]


def layer_spec(cfg: ModelConfig, i: int) -> LayerSpec:
    kind = cfg.layer_kind(i)
    if kind == "attn" and cfg.mla is not None:
        kind = "mla"
    mlp = cfg.mlp_kind(i)
    if cfg.family == "ssm":
        mlp = "none"
    spec = LayerSpec(kind, mlp)
    if spec != LayerSpec("attn", "dense"):
        raise NotImplementedError(
            f"{cfg.name}: layer {i} is {spec}; repro_torch runs only dense "
            "attention + MLP layers so far")
    return spec


def segments(cfg: ModelConfig) -> List[Segment]:
    """One ``stack`` segment of period 1: every layer the port runs is the
    same attention + dense MLP spec (``layer_spec`` raises on any other), so
    the reference's search for the shortest repeating period stops at 1."""
    specs = [layer_spec(cfg, i) for i in range(cfg.n_layers)]
    return [Segment("stack", len(specs), tuple(specs[:1]))]


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def layer_params(pb: ParamBuilder, cfg: ModelConfig):
    return {
        "norm1": norm_params(pb, cfg),
        "mix": attn_mod.attn_params(pb, cfg),
        "norm2": norm_params(pb, cfg),
        "mlp": mlp_params(pb, cfg),
    }


def segment_params(pb: ParamBuilder, cfg: ModelConfig, seg: Segment):
    def one(pb_):
        return {f"l{j}": layer_params(pb_, cfg) for j in range(len(seg.specs))}

    return stacked(pb, seg.n_steps, one)


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str = "cpu"):
    """Zero k, v cache tree. The leading dim of every leaf is ``seg.n_steps``."""
    dt = torch_dtype(cfg.compute_dtype)
    tree: Dict[str, Any] = {}
    for seg in segments(cfg):
        shape = (seg.n_steps, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        tree[seg.name] = {
            f"l{j}": {k: torch.zeros(shape, dtype=dt, device=device) for k in ("k", "v")}
            for j in range(len(seg.specs))}
    return tree


# --------------------------------------------------------------------------- #
# Layer forward
# --------------------------------------------------------------------------- #
def layer_forward(p, x: torch.Tensor, cfg: ModelConfig,
                  *, mode: str, positions=None, pos=None, cache=None,
                  attn_impl: str = "kernel"):
    """One attention + dense MLP layer. Returns (x, new_cache_leaves)."""
    new_cache: Dict[str, torch.Tensor] = {}
    h = apply_norm(p["norm1"], x, cfg)
    use_rope = cfg.pos_embedding == "rope"
    if mode == "decode":
        y, nk, nv = attn_mod.attention_decode(
            p["mix"], h, cfg, cache["k"], cache["v"], pos, use_rope=use_rope)
        new_cache.update(k=nk, v=nv)
    else:
        y, kv = attn_mod.attention_forward(
            p["mix"], h, cfg, positions, causal=True, use_rope=use_rope,
            attn_impl=attn_impl)
        if mode == "prefill":
            new_cache.update(kv)
    x = x + y
    h2 = apply_norm(p["norm2"], x, cfg)
    x = x + apply_mlp(p["mlp"], h2, cfg)
    return x, new_cache


# --------------------------------------------------------------------------- #
# Segment forward
# --------------------------------------------------------------------------- #
def segment_forward(params, x: torch.Tensor, cfg: ModelConfig, seg: Segment,
                    *, mode: str, cache=None, **kw):
    """Run one segment: a loop over the stacked leading axis.

    Returns (x, new_cache_or_None). In ``prefill`` the new cache is the
    per-layer k, v stacked over the leading axis; in ``decode`` it is the
    given cache, updated in place.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    steps = []
    for i in range(seg.n_steps):
        p_i = tree_map(lambda t: t[i], params)
        c_i = tree_map(lambda t: t[i], cache) if cache is not None else None
        new_caches = {}
        for j in range(len(seg.specs)):
            c = c_i[f"l{j}"] if c_i is not None else None
            x, new_caches[f"l{j}"] = layer_forward(p_i[f"l{j}"], x, cfg, mode=mode,
                                                   cache=c, **kw)
        steps.append(new_caches)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, cache
    return x, tree_map(lambda *xs: torch.stack(xs), *steps)
