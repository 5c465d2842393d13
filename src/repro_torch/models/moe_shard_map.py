"""Explicit-collective MoE (shard_map): the expert-parallel path.

Counterpart of ``repro.models.moe_shard_map``, run through
``repro_torch.parallel.compat.shard_map`` over the active context's
DeviceMesh, with the reference's schedule:

  per rank (b_loc, s_loc, d) tokens          [batch over (pod,data), seq over model]
    local top-k gate + capacity scatter  ->  (E, C_loc, d)
    all_to_all over 'model'              ->  (E_loc, ep*C_loc, d)    [EP dispatch]
    all_gather of the f-sharded expert weights over 'data' (ZeRO-3)
    expert FFN                           ->  (E_loc, ep*C_loc, d)
    all_to_all back                      ->  (E, C_loc, d)
    local combine                        ->  (b_loc, s_loc, d)

Token drops are per-(rank, expert) capacity, the standard EP semantics. The
router is called through the ``moe`` module (``moe._gate``), so a caller that
wraps it there sees this path's routing too.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.parallel import compat
from repro_torch.parallel.sharding import P, active, mesh_shape

from . import moe as moe_mod
from .config import ModelConfig
from .params import torch_dtype


def _local_moe(router, wi, wg, wo, x, *, cfg: ModelConfig, dp_axes: Tuple[str, ...]):
    """Per-rank body. x: (b_loc, s_loc, d); wi/wg: (E_loc, d, f_loc);
    wo: (E_loc, f_loc, d). Returns (y, aux)."""
    mo = cfg.moe
    dt = torch_dtype(cfg.compute_dtype)
    b_loc, s_loc, d = x.shape
    g = b_loc * s_loc
    x = x.to(dt)

    probs, gate_w, expert_idx = moe_mod._gate({"router": router}, x, cfg)
    aux = moe_mod._aux_loss(probs, expert_idx, mo.n_experts)
    aux = compat.pmean(compat.pmean(aux, "model"), dp_axes)

    capacity = moe_mod.capacity_of(g, cfg)
    gate_w, expert_idx = gate_w.reshape(1, g, -1), expert_idx.reshape(1, g, -1)
    disp, idx = moe_mod._dispatch(x.reshape(1, g, d), expert_idx, mo.n_experts, capacity)

    # EP dispatch: experts go home to their shard
    disp = compat.all_to_all(disp[0], "model", split_axis=0, concat_axis=1)  # (E_loc, ep*C, d)

    # ZeRO-3 weight gathering: expert FFN weights are *stored* f-sharded over
    # 'data'; gather them for the local matmuls (each data rank holds
    # different tokens, so partial-f compute + psum would be wrong — the
    # transpose of this gather reduce-scatters the expert grads)
    if "data" in dp_axes:
        wi = compat.all_gather(wi, "data", axis=2)
        wg = compat.all_gather(wg, "data", axis=2)
        wo = compat.all_gather(wo, "data", axis=1)
    h = torch.einsum("ecd,edf->ecf", disp, wi.to(dt))
    gte = torch.einsum("ecd,edf->ecf", disp, wg.to(dt))
    out = torch.einsum("ecf,efd->ecd", F.silu(gte) * h, wo.to(dt))

    out = compat.all_to_all(out, "model", split_axis=1, concat_axis=0)      # (E, C, d)
    y = moe_mod._combine(out[None], idx, gate_w)
    return y.reshape(b_loc, s_loc, d), aux


def moe_forward_shard_map(p, x: torch.Tensor, cfg: ModelConfig
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d), the global batch on every rank -> (y, aux), global.
    Requires an active context over a DeviceMesh with a 'model' axis."""
    mesh = active().mesh
    axis_names = set(mesh_shape(mesh))
    dp_axes = tuple(a for a in ("pod", "data") if a in axis_names)

    x_spec = P(dp_axes if dp_axes else None, "model", None)
    w_spec = P("model", None, "data" if "data" in axis_names else None)
    wo_spec = P("model", "data" if "data" in axis_names else None, None)

    fn = compat.shard_map(functools.partial(_local_moe, cfg=cfg, dp_axes=dp_axes),
                          mesh=mesh, in_specs=(P(), w_spec, w_spec, wo_spec, x_spec),
                          out_specs=(x_spec, P()))
    return fn(p["router"], p["wi"], p["wg"], p["wo"], x)
