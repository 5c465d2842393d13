"""Train step factory: loss -> grads -> Adam update, with optional microbatch
gradient accumulation.

Counterpart of ``repro.train.trainer``. ``make_train_step`` returns
``train_step(state, batch) -> (state, metrics)``; the step updates the
state's params and moments in place (see ``optimizer``) and returns a state
with ``step + 1``. Gradients come from ``torch.autograd.grad`` over detached
views of the params, so no ``.grad`` buffers persist between steps.

Training attention defaults to ``"chunked"`` (exact attention in plain torch
ops), as the reference's ``TrainConfig.attn_impl="xla"``, whose other name it
accepts. The reference's cross-pod int8 gradient compression needs a mesh of
pods: it waits for the parallelism slice and raises here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models import ModelConfig
from repro_torch.models.model import loss_fn
from repro_torch.models.params import tree_items, tree_like

from .optimizer import AdamConfig, adam_update
from .state import TrainState


@dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    compress_pod_grads: bool = False
    attn_impl: str = "chunked"


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
                    tcfg: Optional[TrainConfig] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics)."""
    tcfg = tcfg or TrainConfig()
    if tcfg.compress_pod_grads:
        raise NotImplementedError(
            "compress_pod_grads (cross-pod int8 gradient mean) needs a mesh of pods; "
            "it waits for the parallelism slice of the port (ROADMAP, queue 1)")

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        grads, metrics = _grads_and_metrics(state.params, cfg, batch, tcfg)
        params, opt, opt_m = adam_update(state.params, grads, state.opt, state.step,
                                         opt_cfg, rng=state.rng)
        return (TrainState(step=state.step + 1, rng=state.rng, params=params, opt=opt),
                {**metrics, **opt_m})

    return train_step
