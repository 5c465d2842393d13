"""Mixture-of-experts with GShard-style capacity scatter dispatch.

Counterpart of ``repro.models.moe``. ``MoEConfig.impl`` picks one of three
implementations, as in the reference:

* ``scatter`` — tokens are bucketed into per-expert capacity slots by a
  cumulative position over the routing slots in token-major order; the
  dispatched tensor is laid out ``(groups, experts, capacity, d_model)``.
  Overflow tokens are dropped (capacity factor 1.25 by default), faithful to
  GShard / Switch. The groups are the reference's: one sequence chunk of one
  batch row, from the same loop (``_n_groups``), aiming at ~2 groups per
  device of the active sharding context (one device with none). The
  reference's four ``constrain`` sites mark the group and expert layouts.
* ``shard_map`` — the expert-parallel dispatch over the active context's
  DeviceMesh when it has a ``model`` axis (``moe_shard_map``), as the
  reference under a mesh. With no context it falls through to ``scatter``,
  as the reference does with no mesh; so it does under a ``LogicalMesh``
  (the dry run's), which has no ranks to exchange tokens between.
* ``dense`` (the reduced configs) — every expert runs on every token,
  weighted by the top-k gate; exact, no drops, O(E) FLOPs.

The scatter path records its phases as the spans ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` (``repro_torch.obs``;
attributes ``tokens`` and ``capacity``, the slots an expert has in a group);
every path records the shared experts, where a config has them, as
``moe.shared`` (``tokens``, ``d_ff``). Their backward runs outside them,
under the train step's ``train.backward``.

``MoEConfig.norm_topk_prob`` False (port only, DeepSeek-V2's router) keeps
the top-k softmax probabilities as the gates; the default renormalises them,
as the reference does.

The expert products are plain batched matmuls (``torch.einsum``), as the
reference computes them outside any Pallas kernel. The router picks experts
with ``torch.topk``, which returns the k largest in descending order, as
``jax.lax.top_k`` does; the two may order tied probabilities differently
(``jax.lax.top_k`` puts the lower index first), which random float32 inputs
do not produce.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.parallel.sharding import active, constrain, is_device_mesh

from .config import ModelConfig
from .layers import apply_mlp, mlp_params
from .params import ParamBuilder, torch_dtype


def moe_params(pb: ParamBuilder, cfg: ModelConfig):
    mo = cfg.moe
    d, ff, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
    p = {
        "router": pb.param((d, e), (None, None), scale=0.02),
        "wi": pb.param((e, d, ff), ("experts", None, "mlp_fsdp")),
        "wg": pb.param((e, d, ff), ("experts", None, "mlp_fsdp")),
        "wo": pb.param((e, ff, d), ("experts", "mlp_fsdp", None)),
    }
    if mo.n_shared:
        p["shared"] = mlp_params(pb, cfg, d_ff=mo.n_shared * mo.d_ff_shared)
    return p


def _gate(p, x: torch.Tensor, cfg: ModelConfig):
    """Router: softmax over experts, top-k, renormalised unless
    ``norm_topk_prob`` is False (the gates are then the top-k softmax
    probabilities). x: (..., d)."""
    logits = x.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, expert_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)   # (..., k)
    if cfg.moe.norm_topk_prob:
        gate_w = gate_w / (gate_w.sum(dim=-1, keepdim=True) + 1e-9)
    return probs, gate_w, expert_idx


def _aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * p_e."""
    me = probs.reshape(-1, n_experts).mean(dim=0)
    # a comparison, not bincount, which has no meta kernel (the dry run)
    experts = torch.arange(n_experts, device=expert_idx.device)
    counts = (expert_idx.reshape(-1, 1) == experts).sum(dim=0).float()
    ce = counts / torch.clamp(counts.sum(), min=1.0)
    return n_experts * torch.sum(me * ce)


def _experts_apply(p, xs: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Apply every expert to its slot block. xs: (..., E, C, d) -> same."""
    dt = torch_dtype(cfg.compute_dtype)
    h = torch.einsum("...ecd,edf->...ecf", xs, p["wi"].to(dt))
    g = torch.einsum("...ecd,edf->...ecf", xs, p["wg"].to(dt))
    return torch.einsum("...ecf,efd->...ecd", F.silu(g) * h, p["wo"].to(dt))


def _n_groups(b: int, s: int, ndev: int = 1) -> int:
    """The reference's loop (``moe.py:142-146``): sequence chunks per batch row,
    aiming at ~2 groups per device; with one device a single row of 256 or
    more (even) tokens splits in two, anything else is one group per row."""
    n_chunks = 1
    while (b * n_chunks * 2 <= 2 * ndev and s // (n_chunks * 2) >= 128
           and s % (n_chunks * 2) == 0):
        n_chunks *= 2
    return n_chunks


def capacity_of(g_len: int, cfg: ModelConfig) -> int:
    """Slots per expert in a group of ``g_len`` tokens (reference ``:151``)."""
    mo = cfg.moe
    return max(1, int(g_len * mo.top_k / mo.n_experts * mo.capacity_factor))


def _dispatch(x: torch.Tensor, expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """x: (G, g, d); expert_idx: (G, g, k). Every group at once, each as the
    reference's ``_dispatch_one_group``: a routing slot's place in its
    expert's queue is the cumulative count over the group's (g*k) slots in
    token-major order; a slot at or past ``capacity`` is dropped (sent to an
    extra row that is cut off). Returns the (G, E, C, d) slots and the
    indices that the combine needs: each routing slot's row in the flat
    (G * E * (C + 1), d) dispatch, its expert, its place, and whether it was
    kept."""
    n, g, k = expert_idx.shape
    d = x.shape[-1]
    flat_e = expert_idx.reshape(n, g * k)                            # routing slots
    # the one-hot is laid out (G, E, g*k) so that the cumulative count runs
    # along the contiguous dim
    experts = torch.arange(n_experts, device=x.device)
    onehot = (flat_e[:, None, :] == experts[None, :, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
    slot_pos = (pos * onehot).sum(dim=1)                             # (G, g*k)
    keep = slot_pos < capacity
    slot_pos = torch.where(keep, slot_pos, capacity).long()          # overflow -> dropped row
    grp = torch.arange(n, device=x.device)[:, None]
    rows = ((grp * n_experts + flat_e) * (capacity + 1) + slot_pos).reshape(-1)
    vals = (x.repeat_interleave(k, dim=1) * keep[..., None].to(x.dtype)).reshape(-1, d)
    # kept slots are distinct rows; every dropped one writes zeros to a cut row
    disp = x.new_zeros((n * n_experts * (capacity + 1), d)).index_copy(0, rows, vals)
    disp = disp.reshape(n, n_experts, capacity + 1, d)[:, :, :capacity]
    return disp, (rows, flat_e, slot_pos, keep)


def _combine(out_slots: torch.Tensor, idx, gate_w: torch.Tensor) -> torch.Tensor:
    """out_slots: (G, E, C, d); gate_w: (G, g, k). Gather each routing slot
    back and sum its k outputs weighted by the gate (a dropped slot weighs 0)."""
    _, flat_e, slot_pos, keep = idx
    n, g, k = gate_w.shape
    e, capacity, d = out_slots.shape[1:]
    grp = torch.arange(n, device=out_slots.device)[:, None]
    rows = ((grp * e + flat_e) * capacity + torch.clamp(slot_pos, max=capacity - 1)).reshape(-1)
    picked = out_slots.reshape(-1, d).index_select(0, rows).reshape(n, g * k, d)
    w = (gate_w.reshape(n, g * k) * keep.to(gate_w.dtype))[..., None].to(out_slots.dtype)
    return (picked * w).reshape(n, g, k, d).sum(dim=2)


def moe_forward(p, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y, aux_loss)."""
    mo = cfg.moe
    if mo.impl not in ("scatter", "shard_map", "dense"):
        raise ValueError(f"unknown MoE impl {mo.impl!r}")
    dt = torch_dtype(cfg.compute_dtype)
    b, s, d = x.shape
    x = x.to(dt)

    ctx = active()
    if (mo.impl == "shard_map" and ctx is not None and is_device_mesh(ctx.mesh)
            and "model" in ctx.shape):
        from .moe_shard_map import moe_forward_shard_map
        y, aux = moe_forward_shard_map(p, x, cfg)
        return _add_shared(p, x, y, cfg), aux

    if mo.impl == "dense":
        probs, gate_w, expert_idx = _gate(p, x, cfg)
        aux = _aux_loss(probs, expert_idx, mo.n_experts)
        h = torch.einsum("bsd,edf->bsef", x, p["wi"].to(dt))
        g = torch.einsum("bsd,edf->bsef", x, p["wg"].to(dt))
        out_e = torch.einsum("bsef,efd->bsed", F.silu(g) * h, p["wo"].to(dt))
        mask = F.one_hot(expert_idx, mo.n_experts).float()             # (b, s, k, E)
        w_full = torch.einsum("bske,bsk->bse", mask, gate_w)
        y = torch.einsum("bsed,bse->bsd", out_e, w_full.to(dt))
    else:   # scatter, and shard_map with no DeviceMesh
        n_chunks = _n_groups(b, s, ctx.n_devices if ctx is not None else 1)
        g_len = s // n_chunks
        capacity = capacity_of(g_len, cfg)
        with obs.span("moe.route", tokens=b * s, capacity=capacity):
            probs, gate_w, expert_idx = _gate(p, x, cfg)
            aux = _aux_loss(probs, expert_idx, mo.n_experts)
        with obs.span("moe.dispatch", tokens=b * s, capacity=capacity):
            xg = constrain(x.reshape(b * n_chunks, g_len, d), ("moe_groups", None, None))
            gw = gate_w.reshape(b * n_chunks, g_len, -1)
            disp, idx = _dispatch(xg, expert_idx.reshape(b * n_chunks, g_len, -1),
                                  mo.n_experts, capacity)
            disp = constrain(disp, ("moe_groups_dp", "moe_experts", None, None))
        with obs.span("moe.experts", tokens=b * s, capacity=capacity):
            out_slots = constrain(_experts_apply(p, disp, cfg),
                                  ("moe_groups_dp", "moe_experts", None, None))
        with obs.span("moe.combine", tokens=b * s, capacity=capacity):
            y = constrain(_combine(out_slots, idx, gw), ("moe_groups", None, None))
            y = y.reshape(b, s, d)
    return _add_shared(p, x, y, cfg), aux


def _add_shared(p, x: torch.Tensor, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """y plus the shared experts' output on every token (one SwiGLU MLP of
    ``n_shared * d_ff_shared``), under the span ``moe.shared``; y alone
    where the config has none."""
    mo = cfg.moe
    if not mo.n_shared:
        return y
    d_ff = mo.n_shared * mo.d_ff_shared
    with obs.span("moe.shared", tokens=x.shape[0] * x.shape[1], d_ff=d_ff):
        return y + apply_mlp(p["shared"], x, cfg)
