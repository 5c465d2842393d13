"""Train step factory: loss -> grads -> (optional compressed cross-pod mean)
-> Adam update, with optional microbatch gradient accumulation.

Counterpart of ``repro.train.trainer``. ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``; the step updates the
state's params and moments in place (see ``optimizer``) and returns a state
with ``step + 1``. Gradients come from ``torch.autograd.grad`` over detached
views of the params, so no ``.grad`` buffers persist between steps.

Training attention defaults to ``"chunked"`` (exact attention in plain torch
ops), as the reference's ``TrainConfig.attn_impl="xla"``, whose other name it
accepts.

Cross-pod gradient compression (``compress_pod_grads``), as the reference's:
the step runs per rank of a DeviceMesh's ``pod`` axis; each pod takes its
share of the global batch, computes its gradients, and the pods exchange
them as **int8 row-quantised** tensors by ``all_gather`` (``_quant_leaf``:
absmax over the last axis, a divide by 127, round half to even) and take the
float32 mean of the dequantised copies, in place of an all-reduce of the
full-precision gradients across the slow inter-pod links. The state stays
replicated: every pod applies the same mean to the same state. This is plain
tensor math, as the reference's jnp (not its Pallas quantiser, which has
another layout).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_items, tree_like, tree_map
from repro_torch.parallel import compat

from .optimizer import AdamConfig, adam_update
from .state import TrainState


@dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    compress_pod_grads: bool = False
    attn_impl: str = "chunked"


# --------------------------------------------------------------------------- #
# Gradient compression across the pod axis
# --------------------------------------------------------------------------- #
def _quant_leaf(g: torch.Tensor):
    amax = g.abs().amax(dim=-1, keepdim=True) if g.ndim else g.abs()
    s = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q, s


def _cross_pod_mean_int8(grads, axis: str = "pod"):
    """all_gather int8 grads over ``axis`` (of the bound mesh), dequantise,
    mean."""
    def one(g):
        q, s = _quant_leaf(g.to(torch.float32))
        qs = compat.all_gather(q, axis, tiled=False)          # (n, ...) int8 on the wire
        ss = compat.all_gather(s, axis, tiled=False)
        return torch.mean(qs.to(torch.float32) * ss, dim=0).to(g.dtype)

    with torch.no_grad():
        return tree_map(one, grads)


def _loss_and_grads(params, paths, leaves, cfg: ModelConfig, batch, tcfg: TrainConfig
                    ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    tracked = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_like(params, dict(zip(paths, tracked))), cfg, batch,
                                attn_impl=tcfg.attn_impl)
        grads = torch.autograd.grad(loss, tracked)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


def _grads_and_metrics(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    paths, leaves = zip(*tree_items(params))
    if tcfg.grad_accum <= 1:
        grads, metrics = _loss_and_grads(params, paths, leaves, cfg, batch, tcfg)
    else:
        # microbatch accumulation over the (global) batch's leading dim, in
        # float32, then the mean; metrics are the last microbatch's
        n = tcfg.grad_accum
        micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        grads = None
        for i in range(n):
            g, metrics = _loss_and_grads(params, paths, leaves, cfg,
                                         {k: v[i] for k, v in micro.items()}, tcfg)
            if grads is None:
                grads = [x.to(torch.float32) for x in g]
            else:
                for acc, x in zip(grads, g):
                    acc.add_(x.to(torch.float32))
        grads = [acc.div_(n) for acc in grads]
    return tree_like(params, dict(zip(paths, grads))), metrics


def make_train_step(cfg: ModelConfig, opt_cfg: AdamConfig,
                    tcfg: Optional[TrainConfig] = None, mesh=None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    With ``compress_pod_grads``, ``mesh`` is a DeviceMesh with a ``pod``
    axis, every rank passes the same global batch, and every rank's state
    takes the same step."""
    tcfg = tcfg or TrainConfig()

    def core(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = _grads_and_metrics(state.params, cfg, batch, tcfg)
        if tcfg.compress_pod_grads:
            grads = _cross_pod_mean_int8(grads)
        params, opt, opt_m = adam_update(state.params, grads, state.opt, state.step,
                                         opt_cfg, rng=state.rng)
        return (TrainState(step=state.step + 1, rng=state.rng, params=params, opt=opt),
                {**metrics, **opt_m})

    if not tcfg.compress_pod_grads:
        return core
    if mesh is None or "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError("compress_pod_grads needs a DeviceMesh with a 'pod' axis")

    def stepped(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with compat.manual(mesh):
            n, i = compat.axis_size("pod"), compat.axis_index("pod")
            local = {}
            for k, v in batch.items():
                if v.shape[0] % n:
                    raise ValueError(f"batch[{k!r}] of {v.shape[0]} rows over {n} pods")
                rows = v.shape[0] // n
                local[k] = v[i * rows:(i + 1) * rows]
            state, metrics = core(state, local)
            # each pod's loss is over its share of the batch: the mean is the
            # global batch's (the update's metrics are the same on every pod)
            metrics = {k: compat.pmean(v.to(torch.float32), "pod").to(v.dtype)
                       for k, v in metrics.items()}
        return state, metrics

    return stepped
