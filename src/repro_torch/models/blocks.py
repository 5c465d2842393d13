"""Decoder block assembly over stacked (leading 'layers' axis) parameters.

Counterpart of ``repro.models.blocks``. An architecture is decomposed into
*segments*: maximal runs of layers whose (mixer, mlp) pattern repeats with a
fixed period, with every leaf stacked over a leading ``n_steps`` axis, as in
the reference (whose checkpoints and caches keep that axis). Where the
reference runs a segment as one ``lax.scan``, the port runs a Python loop over
the leading axis; ``scan_layers`` and ``remat`` change nothing here.

Ported so far: the dense family (attention + dense MLP, as in llama3) and the
SSM family (Mamba-2 mixer, no MLP, as in mamba2). ``layer_spec`` raises
``NotImplementedError`` for MLA and MoE layers, and so for the hybrid family
(whose MLPs are MoE), and ``model.model_params`` for encdec and vlm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch

from . import attention as attn_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, mlp_params, norm_params
from .params import ParamBuilder, stacked, torch_dtype, tree_map

PORTED_SPECS = (("attn", "dense"), ("ssm", "none"))


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
    if (kind, mlp) not in PORTED_SPECS:
        raise NotImplementedError(
            f"{cfg.name}: layer {i} is {LayerSpec(kind, mlp)}; repro_torch runs only "
            "attention + dense MLP and SSM layers so far")
    return LayerSpec(kind, mlp)


def segments(cfg: ModelConfig) -> List[Segment]:
    """The reference's search for the shortest period that repeats over the
    whole stack: one ``stack`` segment of ``n_layers / period`` steps. (The
    reference's dense ``prefix`` segment exists only for MoE models, which
    ``layer_spec`` refuses.)"""
    specs = [layer_spec(cfg, i) for i in range(cfg.n_layers)]
    for p in range(1, len(specs) + 1):
        if len(specs) % p == 0 and all(specs[i] == specs[i % p] for i in range(len(specs))):
            return [Segment("stack", len(specs) // p, tuple(specs[:p]))]
    return []


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def layer_params(pb: ParamBuilder, cfg: ModelConfig, spec: LayerSpec):
    p: Dict[str, Any] = {"norm1": norm_params(pb, cfg)}
    if spec.kind == "attn":
        p["mix"] = attn_mod.attn_params(pb, cfg)
    else:
        p["mix"] = ssm_mod.ssm_params(pb, cfg)
    if spec.mlp != "none":
        p["norm2"] = norm_params(pb, cfg)
        p["mlp"] = mlp_params(pb, cfg)
    return p


def segment_params(pb: ParamBuilder, cfg: ModelConfig, seg: Segment):
    def one(pb_):
        return {f"l{j}": layer_params(pb_, cfg, spec) for j, spec in enumerate(seg.specs)}

    return stacked(pb, seg.n_steps, one)


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def layer_cache_spec(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int):
    """{leaf: (shape, dtype)} of one layer's cache: k, v for attention; the
    conv tail (compute dtype) and the f32 SSD state for an SSM layer."""
    dt = torch_dtype(cfg.compute_dtype)
    if spec.kind == "attn":
        kv = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return {"k": (kv, dt), "v": (kv, dt)}
    d_in, n_heads, conv_dim = ssm_mod.ssm_dims(cfg)
    s = cfg.ssm
    return {"conv": ((batch, s.d_conv - 1, conv_dim), dt),
            "state": ((batch, n_heads, s.head_dim, s.d_state), torch.float32)}


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 device: torch.device | str = "cpu"):
    """Zero cache tree. The leading dim of every leaf is ``seg.n_steps``
    (``device="meta"`` gives the shapes and dtypes without allocating)."""
    tree: Dict[str, Any] = {}
    for seg in segments(cfg):
        tree[seg.name] = {
            f"l{j}": {k: torch.zeros((seg.n_steps,) + shape, dtype=dt, device=device)
                      for k, (shape, dt) in layer_cache_spec(cfg, spec, batch, max_len).items()}
            for j, spec in enumerate(seg.specs)}
    return tree


# --------------------------------------------------------------------------- #
# Layer forward
# --------------------------------------------------------------------------- #
def layer_forward(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                  *, mode: str, positions=None, pos=None, cache=None,
                  attn_impl: str = "kernel"):
    """One layer. Returns (x, new_cache_leaves).

    ``attn_impl`` picks the mixer's implementation: ``"kernel"`` runs the
    hand-written kernel (flash attention, or the SSD scan), ``"chunked"``
    and ``"plain"`` run plain torch (an SSM layer runs ``ssd_chunked`` for
    both). In decode an SSM layer writes its new conv window and state into
    the given cache leaves in place, as attention writes its k and v.
    """
    attn_impl = attn_mod.ATTN_ALIASES.get(attn_impl, attn_impl)
    if attn_impl not in attn_mod.ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {attn_mod.ATTN_IMPLS}, not {attn_impl!r}")
    new_cache: Dict[str, torch.Tensor] = {}
    h = apply_norm(p["norm1"], x, cfg)
    if spec.kind == "attn":
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
    else:  # ssm
        if mode == "decode":
            y, nconv, nstate = ssm_mod.ssm_decode(p["mix"], h, cfg, cache["conv"],
                                                  cache["state"])
            cache["conv"].copy_(nconv)
            cache["state"].copy_(nstate)
            new_cache.update(conv=cache["conv"], state=cache["state"])
        else:
            y, st = ssm_mod.ssm_forward(p["mix"], h, cfg, use_kernel=attn_impl == "kernel")
            if mode == "prefill":
                new_cache.update(st)
    x = x + y
    if spec.mlp != "none":
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
    per-layer leaves stacked over the leading axis; in ``decode`` it is the
    given cache, updated in place.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    steps = []
    for i in range(seg.n_steps):
        p_i = tree_map(lambda t: t[i], params)
        c_i = tree_map(lambda t: t[i], cache) if cache is not None else None
        new_caches = {}
        for j, spec in enumerate(seg.specs):
            c = c_i[f"l{j}"] if c_i is not None else None
            x, new_caches[f"l{j}"] = layer_forward(p_i[f"l{j}"], x, cfg, spec, mode=mode,
                                                   cache=c, **kw)
        steps.append(new_caches)
    if mode == "train":
        return x, None
    if mode == "decode":
        return x, cache
    return x, tree_map(lambda *xs: torch.stack(xs), *steps)
