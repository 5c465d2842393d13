"""GPipe-style pipeline parallelism over a mesh axis (opt-in).

Counterpart of ``repro.parallel.pipeline``. ``pipeline`` runs a stack of
layers split into P stages along a mesh axis (typically ``pod``),
microbatching the batch dim and rotating activations between stages around
a ring (``compat.ppermute_ring``: ``dist.batch_isend_irecv`` on the axis's
group, the counterpart of ``jax.lax.ppermute``); bubble fraction
(P-1)/(M+P-1).

The schedule is written out by hand on ``compat.shard_map``, as the
reference's: stage s holds layers [s*L/P, (s+1)*L/P) (their params sharded
over the axis by the leading stage dim), and at tick t processes microbatch
(t - s). Outputs surface on the last stage and are rotated back to stage 0
so the output spec stays batch-sharded. (``torch.distributed.pipelining``
splits a module into stage submodules and returns the output on the last
stage: not this contract.) Every rank makes the same collective calls at
every tick; only the compute is skipped on a stage with no microbatch.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import compat
from .sharding import P, mesh_shape


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def pipeline(layer_fn: Callable, stage_params, x: torch.Tensor, *,
             mesh, axis: str = "pod", n_micro: int = None) -> torch.Tensor:
    """Run ``layer_fn(params_i, h) -> h`` for every layer, pipelined.

    stage_params: tensor tree with leading dim = n_stages (sharded over
                  ``axis``), second dim = layers_per_stage.
    x: (batch, ...) global input; batch must divide n_micro * n_stages.
    Returns the layer stack's output, the same shape as x, on every rank.
    """
    n_stages = mesh_shape(mesh)[axis]
    n_micro = n_micro or n_stages * 2
    b = x.shape[0]
    if b % n_micro or b % n_stages:
        raise ValueError(f"batch {b} over {n_micro} microbatches and {n_stages} stages")

    def stage_body(params_local, x_local):
        # params_local: (1, layers_per_stage, ...) — this stage's layers;
        # x_local: (b/n_stages, ...) — batch shard, gathered to the full
        # batch of microbatches on stage 0's schedule
        params_local = _tree_map(lambda t: t[0], params_local)
        n_layers = next(iter(_leaves(params_local))).shape[0]
        stage = compat.axis_index(axis)
        xs = compat.all_gather(x_local, axis, axis=0)
        micro = xs.reshape((n_micro, b // n_micro) + tuple(xs.shape[1:]))

        def run_stage(h):
            for i in range(n_layers):
                h = layer_fn(_tree_map(lambda t: t[i], params_local), h)
            return h

        h_in = torch.zeros_like(micro[0])
        outs = [torch.zeros_like(micro[0]) for _ in range(n_micro)]
        for t in range(n_micro + n_stages - 1):
            # stage 0 injects microbatch t; the others take what they received
            h = micro[t] if stage == 0 and t < n_micro else h_in
            if 0 <= t - stage < n_micro:
                h = run_stage(h)
                if stage == n_stages - 1:
                    outs[t - (n_stages - 1)] = h
            # rotate forward: stage s -> s+1 (ring; stage P-1 -> 0 unused)
            h_in = compat.ppermute_ring(h, axis)
        # outputs live on the last stage; one rotation brings them to stage
        # 0, whose copy every stage then takes from the gather's slot 0
        full = compat.ppermute_ring(torch.stack(outs), axis)
        full = compat.all_gather(full, axis, axis=0, tiled=False)[0]
        full = full.reshape((b,) + tuple(x_local.shape[1:]))
        return full.reshape((n_stages, b // n_stages) + tuple(x_local.shape[1:]))[stage]

    p_spec = _tree_map(lambda _: P(axis), stage_params)
    fn = compat.shard_map(stage_body, mesh=mesh, in_specs=(p_spec, P(axis)),
                          out_specs=P(axis))
    return fn(stage_params, x)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
