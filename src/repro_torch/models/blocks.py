"""Decoder block assembly over stacked (leading 'layers' axis) parameters.

Counterpart of ``repro.models.blocks``. An architecture is decomposed into
*segments*: maximal runs of layers whose (mixer, mlp) pattern repeats with a
fixed period, with every leaf stacked over a leading ``n_steps`` axis, as in
the reference (whose checkpoints and caches keep that axis). Where the
reference runs a segment as one ``lax.scan``, the port runs a Python loop over
the leading axis; ``scan_layers`` and ``remat`` change nothing here.

  llama3 / olmo / yi / phi4 : 1 segment, period [(attn, dense)]
  olmoe                     : 1 segment, period [(attn, moe)]
  deepseek-v3               : prefix 3x(mla, dense) + 58x(mla, moe)
  jamba                     : 4x period-8 [7x(ssm, .) + 1x(attn, .)], moe on odd
  mamba2                    : 1 segment, period [(ssm, none)]
  qwen2-vl                  : 1 segment, period [(attn, dense)], M-RoPE
  whisper                   : encoder (model.py) + decoder segment with cross
                              attention [(attn, dense, cross)]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.parallel.sharding import constrain

from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import apply_mlp, apply_norm, mlp_params, norm_params
from .params import ParamBuilder, stacked, torch_dtype, tree_map, unstack


@dataclass(frozen=True)
class LayerSpec:
    kind: str          # attn | mla | ssm
    mlp: str           # dense | moe | none
    cross: bool = False   # cross attention to the encoder after the mixer


@dataclass(frozen=True)
class Segment:
    name: str
    n_steps: int
    specs: Tuple[LayerSpec, ...]


def layer_spec(cfg: ModelConfig, i: int, cross: bool = False) -> LayerSpec:
    kind = cfg.layer_kind(i)
    if kind == "attn" and cfg.mla is not None:
        kind = "mla"
    mlp = cfg.mlp_kind(i)
    if cfg.family == "ssm":
        mlp = "none"
    return LayerSpec(kind, mlp, cross)


def segments(cfg: ModelConfig, cross: bool = False) -> List[Segment]:
    """The reference's segments: a ``prefix`` of the ``first_k_dense`` leading
    dense layers of an MoE model, then one ``stack`` segment over the shortest
    period that repeats over the rest. ``cross`` gives every layer cross
    attention (the encoder-decoder's decoder)."""
    specs = [layer_spec(cfg, i, cross) for i in range(cfg.n_layers)]
    segs: List[Segment] = []
    start = 0
    if cfg.moe is not None and cfg.moe.first_k_dense > 0:
        k = cfg.moe.first_k_dense
        if any(s != specs[0] for s in specs[:k]):
            raise ValueError(f"{cfg.name}: the first {k} layers differ: {specs[:k]}")
        segs.append(Segment("prefix", k, (specs[0],)))
        start = k
    rest = specs[start:]
    for p in range(1, len(rest) + 1):
        if len(rest) % p == 0 and all(rest[i] == rest[i % p] for i in range(len(rest))):
            segs.append(Segment("stack", len(rest) // p, tuple(rest[:p])))
            break
    return segs


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def layer_params(pb: ParamBuilder, cfg: ModelConfig, spec: LayerSpec):
    p: Dict[str, Any] = {"norm1": norm_params(pb, cfg)}
    if spec.kind == "attn":
        p["mix"] = attn_mod.attn_params(pb, cfg)
    elif spec.kind == "mla":
        p["mix"] = mla_mod.mla_params(pb, cfg)
    else:
        p["mix"] = ssm_mod.ssm_params(pb, cfg)
    if spec.cross:
        p["norm_c"] = norm_params(pb, cfg)
        p["cross"] = attn_mod.attn_params(pb, cfg)
    if spec.mlp != "none":
        p["norm2"] = norm_params(pb, cfg)
        p["mlp"] = moe_mod.moe_params(pb, cfg) if spec.mlp == "moe" else mlp_params(pb, cfg)
    return p


def segment_params(pb: ParamBuilder, cfg: ModelConfig, seg: Segment):
    def one(pb_):
        return {f"l{j}": layer_params(pb_, cfg, spec) for j, spec in enumerate(seg.specs)}

    return stacked(pb, seg.n_steps, one)


# --------------------------------------------------------------------------- #
# Cache
# --------------------------------------------------------------------------- #
def layer_cache_spec(cfg: ModelConfig, spec: LayerSpec, batch: int, max_len: int,
                     enc_len: Optional[int] = None):
    """{leaf: (shape, dtype, logical axes)} of one layer's cache: k, v for
    attention; the ``ckv`` and ``kpe`` latents for MLA; the conv tail
    (compute dtype) and the f32 SSD state for an SSM layer; and for a layer
    with cross attention the encoder's ``ek``, ``ev`` over ``enc_len``
    frames."""
    dt = torch_dtype(cfg.compute_dtype)
    if spec.kind == "attn":
        kv = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
        ax = ("batch", "cache_seq", "act_kv_heads", None)
        out = {"k": (kv, dt, ax), "v": (kv, dt, ax)}
    elif spec.kind == "mla":
        m = cfg.mla
        ax = ("batch", "cache_seq", None)
        out = {"ckv": ((batch, max_len, m.kv_lora_rank), dt, ax),
               "kpe": ((batch, max_len, m.qk_rope_dim), dt, ax)}
    else:
        d_in, n_heads, conv_dim = ssm_mod.ssm_dims(cfg)
        s = cfg.ssm
        out = {"conv": ((batch, s.d_conv - 1, conv_dim), dt, ("batch", None, "act_mlp")),
               "state": ((batch, n_heads, s.head_dim, s.d_state), torch.float32,
                         ("batch", "state_heads", None, None))}
    if spec.cross:
        if enc_len is None:
            raise ValueError(f"{cfg.name}: a cache with cross attention needs enc_len")
        ekv = (batch, enc_len, cfg.n_kv_heads, cfg.d_head)
        ax = ("batch", None, "act_kv_heads", None)
        out.update(ek=(ekv, dt, ax), ev=(ekv, dt, ax))
    return out


def cache_struct(cfg: ModelConfig, batch: int, max_len: int,
                 enc_len: Optional[int] = None, device: torch.device | str = "cpu",
                 mode: str = "zeros"):
    """Zero cache tree (``mode="zeros"``), or the same tree of logical-axis
    tuples (``mode="axes"``). The leading dim of every leaf is
    ``seg.n_steps`` (``device="meta"`` gives the shapes and dtypes without
    allocating). ``enc_len`` sizes the encoder-decoder's ``ek`` / ``ev``
    leaves."""
    if mode not in ("zeros", "axes"):
        raise ValueError(f"unknown mode {mode!r}")

    def leaf(n_steps, shape, dt, ax):
        if mode == "axes":
            return (None,) + ax
        return torch.zeros((n_steps,) + shape, dtype=dt, device=device)

    tree: Dict[str, Any] = {}
    for seg in segments(cfg, cross=cfg.family == "encdec"):
        tree[seg.name] = {
            f"l{j}": {k: leaf(seg.n_steps, *v)
                      for k, v in layer_cache_spec(cfg, spec, batch, max_len, enc_len).items()}
            for j, spec in enumerate(seg.specs)}
    return tree


# --------------------------------------------------------------------------- #
# Layer forward
# --------------------------------------------------------------------------- #
def layer_forward(p, x: torch.Tensor, cfg: ModelConfig, spec: LayerSpec,
                  *, mode: str, positions=None, pos=None, cache=None,
                  enc_out=None, mrope_sections=None, attn_impl: str = "kernel"):
    """One layer. Returns (x, new_cache_leaves, aux_loss).

    ``attn_impl`` picks the mixer's implementation: ``"kernel"`` runs the
    hand-written kernel (flash attention, or the SSD scan), ``"chunked"``
    and ``"plain"`` run plain torch (an SSM layer runs ``ssd_chunked`` for
    both; an MLA layer runs ``chunked_attention`` under all three, see
    ``mla``). In decode an SSM layer writes its new conv window and state
    into the given cache leaves in place, as attention writes its k and v
    and MLA its latents. ``aux_loss`` is the MoE load-balance loss of an MoE
    layer, else a zero scalar.

    A layer with cross attention attends to the encoder's k, v after its
    mixer: projected from ``enc_out`` in train and prefill (``attn_impl``
    as for the mixer; prefill caches them as ``ek`` / ``ev``), read from
    the cache in decode (plain torch, as every decode attention) and passed
    through unchanged.
    """
    attn_impl = attn_mod.ATTN_ALIASES.get(attn_impl, attn_impl)
    if attn_impl not in attn_mod.ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {attn_mod.ATTN_IMPLS}, not {attn_impl!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache: Dict[str, torch.Tensor] = {}
    h = apply_norm(p["norm1"], x, cfg)
    if spec.kind == "attn":
        use_rope = cfg.pos_embedding == "rope"
        if mode == "decode":
            y, nk, nv = attn_mod.attention_decode(
                p["mix"], h, cfg, cache["k"], cache["v"], pos,
                mrope_sections=mrope_sections, use_rope=use_rope)
            new_cache.update(k=nk, v=nv)
        else:
            y, kv = attn_mod.attention_forward(
                p["mix"], h, cfg, positions, causal=True, mrope_sections=mrope_sections,
                use_rope=use_rope, attn_impl=attn_impl)
            if mode == "prefill":
                new_cache.update(kv)
    elif spec.kind == "mla":
        if mode == "decode":
            y, nckv, nkpe = mla_mod.mla_decode(p["mix"], h, cfg, cache["ckv"], cache["kpe"], pos)
            new_cache.update(ckv=nckv, kpe=nkpe)
        else:
            y, latent = mla_mod.mla_forward(p["mix"], h, cfg, positions)
            if mode == "prefill":
                new_cache.update(latent)
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
    x = constrain(x + y, ("batch", "seq", "act_embed"))
    if spec.cross:
        hc = apply_norm(p["norm_c"], x, cfg)
        if mode == "decode":
            ekv = (cache["ek"], cache["ev"])
            new_cache.update(ek=cache["ek"], ev=cache["ev"])      # pass through
            cross_impl = "chunked"
        else:
            ekv = attn_mod.project_enc_kv(p["cross"], enc_out, cfg)
            if mode == "prefill":
                new_cache.update(ek=ekv[0], ev=ekv[1])
            cross_impl = attn_impl
        x = x + attn_mod.cross_attention_forward(p["cross"], hc, ekv, cfg, cross_impl)
    if spec.mlp != "none":
        h2 = apply_norm(p["norm2"], x, cfg)
        if spec.mlp == "moe":
            y2, a = moe_mod.moe_forward(p["mlp"], h2, cfg)
            aux = aux + a
        else:
            y2 = apply_mlp(p["mlp"], h2, cfg)
        x = constrain(x + y2, ("batch", "seq", "act_embed"))
    return x, new_cache, aux


# --------------------------------------------------------------------------- #
# Segment forward
# --------------------------------------------------------------------------- #
def segment_forward(params, x: torch.Tensor, cfg: ModelConfig, seg: Segment,
                    *, mode: str, cache=None, **kw):
    """Run one segment: a loop over the stacked leading axis, whose leaves
    are split once (``params.unstack``).

    Returns (x, new_cache_or_None, aux). In ``prefill`` the new cache is the
    per-layer leaves stacked over the leading axis; in ``decode`` it is the
    given cache, updated in place. ``aux`` sums the layers' MoE losses.
    """
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    steps = []
    for i, p_i in enumerate(unstack(params, seg.n_steps)):
        c_i = tree_map(lambda t: t[i], cache) if cache is not None else None
        new_caches = {}
        for j, spec in enumerate(seg.specs):
            c = c_i[f"l{j}"] if c_i is not None else None
            x, new_caches[f"l{j}"], a = layer_forward(p_i[f"l{j}"], x, cfg, spec, mode=mode,
                                                      cache=c, **kw)
            aux = aux + a
        steps.append(new_caches)
    if mode == "train":
        return x, None, aux
    if mode == "decode":
        return x, cache, aux
    return x, tree_map(lambda *xs: torch.stack(xs), *steps), aux
