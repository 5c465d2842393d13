"""Top-level language model: embed -> segments -> final norm -> logits.

Counterpart of ``repro.models.model``, for every family of the reference:
dense, MoE (with MLA and DeepSeek's MTP head), SSM, the SSM + attention
hybrid, the encoder-decoder (Whisper's backbone: a bidirectional encoder over
stub frame embeddings, sinusoidal positions, cross attention in every decoder
layer) and the VLM (Qwen2-VL's backbone: stub patch embeddings in place of
the first token embeddings, M-RoPE).

``attn_impl`` picks the implementation of every attention and SSM mixer in
the model, the encoder's self-attention and the decoder's cross attention
included, the same argument for every family (an MLA layer runs
``chunked_attention`` under all three; see ``mla``):

* ``"kernel"`` (the serving default): the hand-written kernel, flash
  attention or the SSD chunked scan (their plain versions for tensors on the
  CPU). Forward only.
* ``"chunked"`` (the training default; ``"xla"`` is its other name):
  ``chunked_attention``, or ``ssd_chunked`` for an SSM layer, differentiable,
  as the reference trains.
* ``"plain"``: the kernels' plain versions (``ssd_chunked`` for an SSM
  layer), so that the card can hold a kernel prefill against an all-plain one.

`Batch` contract (as in the reference; all optional unless the family needs
them):
  tokens         (b, s) integer     decoder token ids
  labels         (b, s) integer     next-token targets (-1 = masked; loss only)
  enc_embeds     (b, enc_len, d)    whisper's stub frontend output
  vision_embeds  (b, n_vis, d)      qwen2-vl's stub patch embeddings
  positions      (b, s) or (3, b, s) overrides the default arange (M-RoPE)
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.parallel.sharding import constrain

from . import attention as attn_mod
from . import blocks
from .config import ModelConfig
from .layers import (apply_mlp, apply_norm, embed_tokens, embedding_params, lm_logits,
                     norm_params)
from .params import ParamBuilder, torch_dtype, tree_map


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def model_params(pb: ParamBuilder, cfg: ModelConfig):
    p: Dict[str, Any] = {"tok": embedding_params(pb, cfg)}
    if cfg.family == "encdec":
        # the encoder's layers: bidirectional attention and a dense MLP
        enc = blocks.Segment("enc", cfg.encdec.n_enc_layers, (blocks.LayerSpec("attn", "dense"),))
        p["encoder"] = {"seg": blocks.segment_params(pb, cfg, enc),
                        "norm_f": norm_params(pb, cfg)}
    p["segments"] = {seg.name: blocks.segment_params(pb, cfg, seg)
                     for seg in blocks.segments(cfg, cross=cfg.family == "encdec")}
    p["norm_f"] = norm_params(pb, cfg)
    if cfg.mtp_depth > 0:
        # DeepSeek MTP (depth 1): one more layer of the last layer's kind
        p["mtp"] = {
            "proj": pb.param((2 * cfg.d_model, cfg.d_model), ("embed", "embed")),
            "norm_h": norm_params(pb, cfg),
            "norm_e": norm_params(pb, cfg),
            "layer": blocks.layer_params(pb, cfg, blocks.layer_spec(cfg, cfg.n_layers - 1)),
            "norm_f": norm_params(pb, cfg),
        }
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[str | torch.dtype] = None):
    """Random weights from a seeded ``torch.Generator`` on ``device``.

    Same tree, leaf names and scale rules as the reference's ``init_params``
    (not the same numbers). Leaves are made in float32 and cast one at a time
    to ``dtype`` (default ``cfg.param_dtype``); serving passes
    ``cfg.compute_dtype`` so that no float32 copy of the model is ever held.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pb = ParamBuilder("init", generator=gen, device=dev,
                      param_dtype=torch_dtype(dtype or cfg.param_dtype))
    return model_params(pb, cfg)


def param_shapes(cfg: ModelConfig):
    """The parameter tree with :class:`ParamSpec` leaves (no allocation)."""
    return model_params(ParamBuilder("shape", param_dtype=torch_dtype(cfg.param_dtype)), cfg)


def param_axes(cfg: ModelConfig):
    """The parameter tree with logical-axis tuples as leaves."""
    return model_params(ParamBuilder("axes"), cfg)


# --------------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------------- #
def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings (..., d) in float32, the reference's:
    its frequency divisor is ``max(half - 1, 1)``, not Whisper's."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                       device=positions.device)
                     / max(half - 1, 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _default_positions(cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The batch's ``positions``, else the arange over the sequence: (b, s),
    or the same in all three M-RoPE streams, (3, b, s), for a VLM."""
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)
    if cfg.vlm is not None:
        return pos[None].expand((3,) + tuple(tokens.shape))
    return pos


def _embed_inputs(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings in the compute dtype; a VLM's ``vision_embeds``
    replace the first ones, and sinusoidal positions are added."""
    x = embed_tokens(params["tok"], batch["tokens"], cfg)
    if cfg.vlm is not None and "vision_embeds" in batch:
        vis = batch["vision_embeds"]
        x = torch.cat([vis.to(x.dtype), x[:, vis.shape[1]:]], dim=1)
    if cfg.pos_embedding == "sinusoid":
        pos = torch.arange(x.shape[1], device=x.device)[None]
        x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    return constrain(x, ("batch", "seq", "act_embed"))


def _run_encoder(params, cfg: ModelConfig, enc_embeds: torch.Tensor,
                 attn_impl: str = "kernel") -> torch.Tensor:
    """The encoder over the stub frame embeddings: bidirectional attention
    without RoPE, a loop over its stacked layers (the reference's unscanned
    branch)."""
    enc = params["encoder"]
    x = enc_embeds.to(torch_dtype(cfg.compute_dtype))
    pos = torch.arange(x.shape[1], device=x.device)[None]
    if cfg.pos_embedding == "sinusoid":
        x = x + _sinusoid(pos, cfg.d_model).to(x.dtype)
    for i in range(cfg.encdec.n_enc_layers):
        p_l = tree_map(lambda t: t[i], enc["seg"])["l0"]
        h = apply_norm(p_l["norm1"], x, cfg)
        y, _ = attn_mod.attention_forward(p_l["mix"], h, cfg, pos, causal=False,
                                          use_rope=False, attn_impl=attn_impl)
        x = x + y
        x = x + apply_mlp(p_l["mlp"], apply_norm(p_l["norm2"], x, cfg), cfg)
    return apply_norm(enc["norm_f"], x, cfg)


def zero_extras(cfg: ModelConfig, batch: int, seq: int, device) -> Dict[str, torch.Tensor]:
    """The stub frontends' outputs a training batch carries, as the
    reference's launcher and worker make them: zero float32 ``enc_embeds``
    (batch, enc_len, d_model) for the encoder-decoder, zero ``vision_embeds``
    (batch, min(n_vision_tokens, seq), d_model) for the VLM; else none."""
    if cfg.family == "encdec":
        return {"enc_embeds": torch.zeros(batch, cfg.encdec.enc_len, cfg.d_model,
                                          device=device)}
    if cfg.family == "vlm":
        return {"vision_embeds": torch.zeros(batch, min(cfg.vlm.n_vision_tokens, seq),
                                             cfg.d_model, device=device)}
    return {}


def _run_segments(params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                  cache=None, positions=None, pos=None, enc_out=None,
                  attn_impl: str = "kernel"):
    mrope = cfg.vlm.mrope_sections if cfg.vlm is not None else None
    new_cache: Dict[str, Any] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in blocks.segments(cfg, cross=cfg.family == "encdec"):
        c = cache[seg.name] if cache is not None else None
        x, nc, a = blocks.segment_forward(
            params["segments"][seg.name], x, cfg, seg, mode=mode, cache=c,
            positions=positions, pos=pos, enc_out=enc_out, mrope_sections=mrope,
            attn_impl=attn_impl)
        aux = aux + a
        if nc is not None:
            new_cache[seg.name] = nc
    return x, (new_cache if new_cache else None), aux


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            mode: str = "train", attn_impl: str = "kernel"):
    """Train / prefill forward. Returns (logits, cache_or_None, aux, x).

    ``aux`` is the sum of the MoE layers' load-balance losses (a zero scalar
    for a model without MoE layers); ``x`` is the final hidden state, which
    the MTP loss reads.
    """
    positions = _default_positions(cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _run_encoder(params, cfg, batch["enc_embeds"], attn_impl)
    x, cache, aux = _run_segments(params, cfg, x, mode=mode, positions=positions,
                                  enc_out=enc_out, attn_impl=attn_impl)
    x = apply_norm(params["norm_f"], x, cfg)
    logits = constrain(lm_logits(params["tok"], x, cfg), ("batch", "seq", "act_vocab"))
    return logits, cache, aux, x


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over labels >= 0. logits: (b, s, v) any float; labels: (b, s).

    The reference picks the label's logit with an iota == label select-sum so
    that XLA can keep the vocab dim sharded. That sum has one non-zero term,
    so ``torch.gather`` gives the same number exactly, without three
    (b, s, vocab) temporaries (2 GB each at llama3-8b width and 4 x 1024
    tokens).
    """
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    ll = torch.gather(logits, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(mask, lse - ll, 0.0)
    return nll.sum() / torch.clamp(mask.float().sum(), min=1.0)


def _mtp_loss(params, cfg: ModelConfig, h_final: torch.Tensor,
              batch: Dict[str, torch.Tensor], positions: torch.Tensor,
              attn_impl: str) -> torch.Tensor:
    """DeepSeek MTP (depth 1): predict token t+2 from h_t and emb(t+1)."""
    mtp = params["mtp"]
    tokens, labels = batch["tokens"], batch["labels"]
    dt = torch_dtype(cfg.compute_dtype)
    # next-token embeddings: shift tokens left by one
    nxt = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    e = apply_norm(mtp["norm_e"], embed_tokens(params["tok"], nxt, cfg), cfg)
    h = apply_norm(mtp["norm_h"], h_final, cfg)
    x = torch.cat([h, e], dim=-1).to(dt) @ mtp["proj"].to(dt)
    spec = blocks.layer_spec(cfg, cfg.n_layers - 1)
    x, _, _ = blocks.layer_forward(mtp["layer"], x, cfg, spec, mode="train",
                                   positions=positions, attn_impl=attn_impl)
    logits = lm_logits(params["tok"], apply_norm(mtp["norm_f"], x, cfg), cfg)
    # labels shifted by one more step
    lbl2 = torch.cat([labels[:, 1:], torch.full_like(labels[:, -1:], -1)], dim=1)
    return cross_entropy(logits, lbl2)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            attn_impl: str = "chunked") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) as the reference's loss_fn: cross-entropy, plus
    ``moe.aux_loss_weight`` x the MoE load-balance loss (metric ``aux``) and
    0.3 x the MTP loss (metric ``mtp``) where the config has them."""
    logits, _, aux, h_final = forward(params, cfg, batch, mode="train", attn_impl=attn_impl)
    ce = cross_entropy(logits, batch["labels"])
    loss = ce
    metrics = {"ce": ce}
    if cfg.moe is not None and cfg.moe.n_experts > 0:
        loss = loss + cfg.moe.aux_loss_weight * aux
        metrics["aux"] = aux
    if cfg.mtp_depth > 0:
        mtp = _mtp_loss(params, cfg, h_final, batch, _default_positions(cfg, batch),
                        attn_impl)
        loss = loss + 0.3 * mtp
        metrics["mtp"] = mtp
    metrics["loss"] = loss
    return loss, metrics


def decode_step(params, cfg: ModelConfig, token: torch.Tensor, cache,
                pos: torch.Tensor):
    """One-token decode. token: (b,); pos: (b,). Returns (logits, cache).

    The cache is updated in place and returned.
    """
    x = embed_tokens(params["tok"], token[:, None], cfg)
    if cfg.pos_embedding == "sinusoid":
        x = x + _sinusoid(pos[:, None], cfg.d_model).to(x.dtype)
    x, new_cache, _ = _run_segments(params, cfg, x, mode="decode", cache=cache, pos=pos)
    x = apply_norm(params["norm_f"], x, cfg)
    logits = lm_logits(params["tok"], x, cfg)[:, 0]
    return logits, new_cache
