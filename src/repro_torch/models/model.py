"""Top-level language model: embed -> segments -> final norm -> logits.

Counterpart of ``repro.models.model`` for the decoder-only families: dense,
MoE (with MLA and DeepSeek's MTP head), SSM and the SSM + attention hybrid.
The encoder-decoder and VLM families wait for a later slice and raise in
:func:`model_params`.

``attn_impl`` picks the mixer's implementation in every layer, the same
argument for every family (an MLA layer runs ``chunked_attention`` under
all three; see ``mla``):

* ``"kernel"`` (the serving default): the hand-written kernel, flash
  attention or the SSD chunked scan (their plain versions for tensors on the
  CPU). Forward only.
* ``"chunked"`` (the training default; ``"xla"`` is its other name):
  ``chunked_attention``, or ``ssd_chunked`` for an SSM layer, differentiable,
  as the reference trains.
* ``"plain"``: the kernels' plain versions (``ssd_chunked`` for an SSM
  layer), so that the card can hold a kernel prefill against an all-plain one.

`Batch` contract (as in the reference):
  tokens     (b, s) integer  decoder token ids
  labels     (b, s) integer  next-token targets (-1 = masked; loss only)
  positions  (b, s)          overrides the default arange
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device

from . import blocks
from .config import ModelConfig
from .layers import apply_norm, embed_tokens, embedding_params, lm_logits, norm_params
from .params import ParamBuilder, torch_dtype

_UNPORTED = ("encdec", "vlm")


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def model_params(pb: ParamBuilder, cfg: ModelConfig):
    if cfg.family in _UNPORTED:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} is not yet ported")
    p: Dict[str, Any] = {"tok": embedding_params(pb, cfg)}
    p["segments"] = {seg.name: blocks.segment_params(pb, cfg, seg)
                     for seg in blocks.segments(cfg)}
    p["norm_f"] = norm_params(pb, cfg)
    if cfg.mtp_depth > 0:
        # DeepSeek MTP (depth 1): one more layer of the last layer's kind
        p["mtp"] = {
            "proj": pb.param((2 * cfg.d_model, cfg.d_model)),
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


# --------------------------------------------------------------------------- #
# Forward passes
# --------------------------------------------------------------------------- #
def _default_positions(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    if "positions" in batch:
        return batch["positions"]
    tokens = batch["tokens"]
    return torch.arange(tokens.shape[1], device=tokens.device)[None].expand(tokens.shape)


def _run_segments(params, cfg: ModelConfig, x: torch.Tensor, *, mode: str,
                  cache=None, positions=None, pos=None, attn_impl: str = "kernel"):
    new_cache: Dict[str, Any] = {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for seg in blocks.segments(cfg):
        c = cache[seg.name] if cache is not None else None
        x, nc, a = blocks.segment_forward(
            params["segments"][seg.name], x, cfg, seg, mode=mode, cache=c,
            positions=positions, pos=pos, attn_impl=attn_impl)
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
    positions = _default_positions(batch)
    x = embed_tokens(params["tok"], batch["tokens"], cfg)
    x, cache, aux = _run_segments(params, cfg, x, mode=mode, positions=positions,
                                  attn_impl=attn_impl)
    x = apply_norm(params["norm_f"], x, cfg)
    logits = lm_logits(params["tok"], x, cfg)
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
        mtp = _mtp_loss(params, cfg, h_final, batch, _default_positions(batch), attn_impl)
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
    x, new_cache, _ = _run_segments(params, cfg, x, mode="decode", cache=cache, pos=pos)
    x = apply_norm(params["norm_f"], x, cfg)
    logits = lm_logits(params["tok"], x, cfg)[:, 0]
    return logits, new_cache
