"""``shard_map`` over a ``torch.distributed`` DeviceMesh, and the collectives
its bodies call.

Counterpart of ``repro.parallel.compat``, which presents one ``jax.shard_map``
over jax versions. Here every rank holds the *global* tensors, as a jax
program holds global arrays: ``shard_map(f, mesh, in_specs, out_specs)``
slices each input to this rank's block by its spec, runs ``f`` on the blocks
with the mesh's axes bound (``axis_index``, ``axis_size``, ``axis_group``),
and reassembles each output by ``all_gather`` along its out spec, so every
rank returns the same global outputs. On a 1-rank mesh it is slicing by whole
blocks.

Gradients. Every rank runs the same program on the same global tensors, so
every rank holds the same global cotangent. Each rank back-propagates its
*share*: a gathered output hands each rank its own block's cotangent, split
evenly over the ranks that hold the same block (a replicated output, spec
``P()``, gives each rank 1/n of it); the collectives inside ``f`` transpose
as sums (``all_to_all`` back, ``all_gather`` to a reduce-scatter, ``psum``
to a ``psum``); and an input sums the shares of all ranks (an all-reduce of
its block gradients placed in the full shape). Every rank then holds the
true gradient of the global input, once: an autograd all-gather whose
backward reduce-scatters the full cotangent would count it n times.

``COLLECTIVES`` counts the calls of each kind, forward and backward.
"""
from __future__ import annotations

import contextlib
import math
import threading
from collections import Counter
from typing import Any, Callable, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import P, _as_tuple, mesh_shape

COLLECTIVES: Counter = Counter()

_tls = threading.local()


# --------------------------------------------------------------------------- #
# The bound mesh
# --------------------------------------------------------------------------- #
@contextlib.contextmanager
def manual(mesh):
    """Bind ``mesh``'s axes for the collectives below (``shard_map`` does)."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def _mesh():
    mesh = getattr(_tls, "mesh", None)
    if mesh is None:
        raise RuntimeError("no mesh axes are bound: call inside shard_map or manual(mesh)")
    return mesh


def axis_index(name: str) -> int:
    return _mesh().get_local_rank(name)


def axis_size(name: str) -> int:
    return mesh_shape(_mesh())[name]


def axis_group(name: str):
    return _mesh().get_group(name)


def _names(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


# --------------------------------------------------------------------------- #
# Collectives over one axis (autograd-aware)
# --------------------------------------------------------------------------- #
def _all_to_all_raw(x: torch.Tensor, group) -> torch.Tensor:
    """Chunk j of dim 0 goes to rank j; chunk j of the result came from rank j."""
    COLLECTIVES["all_to_all"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _all_gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    """(n, *x.shape): every rank's ``x`` in rank order."""
    COLLECTIVES["all_gather"] += 1
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _all_reduce_raw(x: torch.Tensor, group) -> torch.Tensor:
    COLLECTIVES["all_reduce"] += 1
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all_raw(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        # reduce-scatter: rank j's slice, summed over the ranks' shares
        return _all_to_all_raw(g, ctx.group).sum(0), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_raw(g, ctx.group), None


def all_to_all(x: torch.Tensor, name: str, split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: ``split_axis`` cut into
    ``axis_size`` chunks, chunk j sent to rank j, the received chunks
    concatenated along ``concat_axis`` in rank order."""
    n = axis_size(name)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} over {n} ranks")
    chunks = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    recv = _AllToAll.apply(chunks, axis_group(name))
    return recv.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def all_gather(x: torch.Tensor, name: str, axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``x`` along ``axis`` in rank order
    (concatenated if ``tiled``, else stacked as a new dim ``axis``)."""
    parts = _AllGather.apply(x, axis_group(name))
    if not tiled:
        return parts.movedim(0, axis)
    return parts.movedim(0, axis).flatten(axis, axis + 1)


def psum(x: torch.Tensor, axes) -> torch.Tensor:
    for name in _names(axes):
        x = _AllReduce.apply(x, axis_group(name))
    return x


def pmean(x: torch.Tensor, axes) -> torch.Tensor:
    return psum(x, axes) / math.prod(axis_size(n) for n in _names(axes))


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ring_shift_raw(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ring_shift_raw(g, ctx.group, -ctx.shift), None, None


def _ring_shift_raw(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return x.clone()
    COLLECTIVES["ppermute"] += 1
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ppermute_ring(x: torch.Tensor, name: str, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with ``perm = [(i, (i + shift) % n)]``: rank i's
    ``x`` goes to rank i + shift, by ``dist.batch_isend_irecv``."""
    return _RingShift.apply(x, axis_group(name), shift)


# --------------------------------------------------------------------------- #
# Global tensor <-> this rank's block
# --------------------------------------------------------------------------- #
def _block(mesh, axes: Tuple[str, ...]) -> Tuple[int, int]:
    """(index, count) of this rank's block along a dim split over ``axes``
    (the first axis major)."""
    shape = mesh_shape(mesh)
    idx, n = 0, 1
    for ax in axes:
        idx = idx * shape[ax] + mesh.get_local_rank(ax)
        n *= shape[ax]
    return idx, n


def _local(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        if axes:
            idx, n = _block(mesh, axes)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not split over {axes}")
            size = x.shape[d] // n
            x = x.narrow(d, idx * size, size)
    return x


def _mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    for name in mesh_shape(mesh):
        x = _all_reduce_raw(x, mesh.get_group(name))
    return x


class _ToLocal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh, ctx.shape = spec, mesh, x.shape
        return _local(x, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        _local(full, ctx.spec, ctx.mesh).copy_(g)
        return _mesh_sum(full, ctx.mesh), None, None


class _ToGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        for d, entry in enumerate(spec):
            # innermost axis first, so the first axis of the entry ends major
            for ax in reversed(_as_tuple(entry)):
                x = _all_gather_raw(x, mesh.get_group(ax)).movedim(0, d).flatten(d, d + 1)
        return x

    @staticmethod
    def backward(ctx, g):
        shape = mesh_shape(ctx.mesh)
        blocks = math.prod(shape[ax] for e in ctx.spec for ax in _as_tuple(e))
        holders = math.prod(shape.values()) // blocks
        return _local(g, ctx.spec, ctx.mesh) / holders, None, None


def _map_spec(fn, tree, spec):
    """``fn(leaf, spec)`` over a tensor tree; ``spec`` is one P for every
    leaf, or a tree of P of the same structure."""
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, spec if isinstance(spec, P) else spec[k])
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        specs = [spec] * len(tree) if isinstance(spec, P) else spec
        return type(tree)(_map_spec(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, spec)


def shard_map(f: Callable, mesh, in_specs: Sequence[Any], out_specs: Any) -> Callable:
    """``f`` run per rank on its blocks of global inputs; outputs reassembled
    (see the module docstring). ``in_specs`` has one entry per argument and
    ``out_specs`` the structure of ``f``'s result; an entry is a P for every
    tensor of its tree, or a tree of P."""

    def run(*args):
        local = [_map_spec(lambda t, s: _ToLocal.apply(t, s, mesh), a, spec)
                 for a, spec in zip(args, in_specs, strict=True)]
        with manual(mesh):
            out = f(*local)
        return _map_spec(lambda t, s: _ToGlobal.apply(t, s, mesh), out, out_specs)

    return run
