"""Logical-axis sharding rules.

Counterpart of ``repro.parallel.sharding``. Parameters and activations are
annotated with *logical* axis names (``ParamBuilder``'s ``axes`` mode); this
module maps them onto mesh axes. The rule tables, ``spec_for`` and the
presets are the reference's, verbatim. Legality is enforced structurally:
for every tensor dim only mesh axes that (a) divide the dim and (b) are not
already used by an earlier dim of the same tensor ("first-wins") are kept,
so any rule table gives a valid spec for any shape. Dropped axes mean
replication.

A context's mesh is either a ``torch.distributed`` ``DeviceMesh`` (ranks
that exist: ``placements`` and ``distribute_tree`` place tensors on it as
DTensors, ``constrain`` redistributes a DTensor) or a :class:`LogicalMesh`,
axis names and sizes with no process behind them (the dry run shards over
the 256 and 512 chips of the production meshes). ``n_devices`` comes from
the mesh's shape in both cases. With no context every helper is a no-op, as
the reference's are with no mesh.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

AxisRule = Union[None, str, Tuple[str, ...]]

# ---------------------------------------------------------------------------
# Rule tables
# ---------------------------------------------------------------------------
# Parameters: 2D sharded — FSDP over `data` on the embed axis, TP/EP over
# `model` on heads/mlp/vocab/experts. Replicated across `pod` (gradients are
# all-reduced — optionally compressed — on the pod axis).
PARAM_RULES: Dict[str, AxisRule] = {
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "lora": None,
    "layers": None,
    "mlp_fsdp": "data",      # MoE expert FFN hidden dim (see moe_params)
}

# Activations.
ACT_RULES: Dict[str, AxisRule] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",                  # sequence-parallel sections
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_embed": None,
    "act_mlp": "model",
    "act_vocab": "model",
    "cache_seq": ("pod", "data"),       # used when batch is unshardable (b=1)
    "moe_groups": ("pod", "data", "model"),
    "moe_groups_dp": ("pod", "data"),
    "moe_experts": "model",
    "state_heads": "model",
}

DEFAULT_RULES: Dict[str, AxisRule] = {**PARAM_RULES, **ACT_RULES}

# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------
# megatron (default): 2D param sharding — FSDP over data on embed, TP/EP over
#   model on heads/mlp/vocab/experts; batch over (pod, data).
# fsdp: ZeRO-3-pure — every param sharded over (data, model) on its embed
#   axis, batch over the whole mesh, no tensor-parallel activations. Right
#   for models whose per-layer compute is too small to amortise TP
#   all-reduces (<= ~10B dense at 4k tokens/device).
FSDP_RULES: Dict[str, AxisRule] = {
    **DEFAULT_RULES,
    "embed": ("data", "model"),
    "heads": None,
    "kv_heads": None,
    "mlp": None,
    "vocab": None,
    "batch": ("pod", "data", "model"),
    "act_heads": None,
    "act_kv_heads": None,
    "act_mlp": None,
    "act_vocab": None,
    "moe_groups": ("pod", "data", "model"),
    "moe_groups_dp": ("pod", "data", "model"),
    "moe_experts": None,
}

# megatron_sp: megatron + sequence parallelism on the residual stream — the
# seq dim of activations shards over 'model' between blocks (Korthikanti'22),
# shrinking remat-saved activations and the shard_map MoE boundary reshard by
# the TP degree.
MEGATRON_SP_RULES: Dict[str, AxisRule] = {**DEFAULT_RULES, "seq": "model"}

RULES_PRESETS: Dict[str, Dict[str, AxisRule]] = {
    "megatron": DEFAULT_RULES,
    "megatron_sp": MEGATRON_SP_RULES,
    "fsdp": FSDP_RULES,
}


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None`` (replicated),
    a mesh axis name, or a tuple of them (the dim split over their product,
    the first one major), as ``jax.sharding.PartitionSpec``'s entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class LogicalMesh:
    """Axis names and sizes with no process group: a mesh of chips that need
    not exist, for shape and byte accounting."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.axis_sizes}")


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size}, in mesh order, of a LogicalMesh or a DeviceMesh."""
    if isinstance(mesh, LogicalMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh used for sharding needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


def is_device_mesh(mesh) -> bool:
    return not isinstance(mesh, LogicalMesh)


class ShardingContext:
    def __init__(self, mesh, rules: Optional[Dict[str, AxisRule]] = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES if rules is None else rules)
        self.shape = mesh_shape(mesh)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape.values())


_tls = threading.local()


def active() -> Optional[ShardingContext]:
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Dict[str, AxisRule]] = None):
    """Make ``mesh`` (a DeviceMesh or a LogicalMesh) the active context.

    A context nests inside one of the same kind only: a LogicalMesh inside a
    DeviceMesh's context (or the reverse) would have ``constrain`` and the
    shard_map MoE act on ranks of one mesh with the axes of the other."""
    prev = getattr(_tls, "ctx", None)
    if prev is not None and is_device_mesh(prev.mesh) != is_device_mesh(mesh):
        raise ValueError("a LogicalMesh and a DeviceMesh context cannot nest: "
                         f"{type(mesh).__name__} inside {type(prev.mesh).__name__}")
    _tls.ctx = ShardingContext(mesh, rules)
    try:
        yield _tls.ctx
    finally:
        _tls.ctx = prev


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------
def _as_tuple(rule: AxisRule) -> Tuple[str, ...]:
    if rule is None:
        return ()
    if isinstance(rule, str):
        return (rule,)
    return tuple(rule)


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int],
             ctx: Optional[ShardingContext] = None) -> P:
    """Build a legal partition spec for `shape` from logical `axes`."""
    ctx = ctx or active()
    if ctx is None:
        return P()
    mesh_shape_ = ctx.shape
    used: set = set()
    dims = []
    for name, size in zip(axes, shape):
        chosen = []
        for ax in _as_tuple(ctx.rules.get(name)) if name else ():
            if ax in used or ax not in mesh_shape_:
                continue
            prod = 1
            for c in chosen:
                prod *= mesh_shape_[c]
            if size % (prod * mesh_shape_[ax]) == 0:
                chosen.append(ax)
                used.add(ax)
        if not chosen:
            dims.append(None)
        elif len(chosen) == 1:
            dims.append(chosen[0])
        else:
            dims.append(tuple(chosen))
    while dims and dims[-1] is None:
        dims.pop()
    return P(*dims)


def shards_of(spec: P, mesh) -> int:
    """How many ways ``spec`` splits a tensor over ``mesh``."""
    shape = mesh_shape(mesh)
    return math.prod(shape[ax] for entry in spec for ax in _as_tuple(entry))


def placements(spec: P, mesh) -> list:
    """DTensor placements over ``mesh``'s dims for ``spec``: ``Shard(d)`` on a
    mesh dim that splits tensor dim ``d``, else ``Replicate()``. A tensor dim
    split over several mesh dims is split by them in mesh order (DTensor's
    rule), so an entry must list its axes in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _as_tuple(entry)
        order = [names.index(ax) for ax in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order {tuple(names)}")
        for i in order:
            out[i] = Shard(d)
    return out


def _is_axes_leaf(x) -> bool:
    return (type(x) is tuple and all(isinstance(a, (str, type(None))) for a in x))


def map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree (nested dicts, NamedTuples and
    axes tuples) and trees of the same structure."""
    if _is_axes_leaf(axes_tree):
        return fn(axes_tree, *trees)
    if isinstance(axes_tree, dict):
        return {k: map_axes(fn, axes_tree[k], *(t[k] for t in trees)) for k in axes_tree}
    if isinstance(axes_tree, tuple) and hasattr(axes_tree, "_fields"):
        return type(axes_tree)(*(map_axes(fn, a, *(getattr(t, f) for t in trees))
                                 for f, a in zip(axes_tree._fields, axes_tree)))
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """With a DeviceMesh context and a DTensor ``x``: ``x`` redistributed to
    ``spec_for``'s placements on its mesh. Otherwise (no context, a logical
    mesh, a plain tensor) ``x`` itself. The value is unchanged either way, as
    under ``with_sharding_constraint``."""
    ctx = active()
    if ctx is None or not is_device_mesh(ctx.mesh):
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    if x.device_mesh != ctx.mesh:
        raise ValueError("constrain: the DTensor lives on another mesh than the context's")
    return x.redistribute(ctx.mesh, placements(spec_for(axes, x.shape, ctx), ctx.mesh))


def tree_specs(axes_tree, shape_tree, mesh, rules: Optional[Dict[str, AxisRule]] = None):
    """Partition-spec tree for (axes, shape) trees; a shape leaf is anything
    with a ``.shape`` (a tensor, a meta tensor, a ``ParamSpec``)."""
    ctx = ShardingContext(mesh, rules)
    return map_axes(lambda axes, leaf: spec_for(axes, leaf.shape, ctx), axes_tree, shape_tree)


def distribute_tree(tree, axes_tree, mesh, rules: Optional[Dict[str, AxisRule]] = None):
    """The counterpart of ``tree_shardings`` (a jitted step's
    ``in_shardings``): each tensor placed on the DeviceMesh ``mesh`` as a
    DTensor with ``spec_for``'s placements. Every rank passes the same full
    tensors; each keeps its shards."""
    from torch.distributed.tensor import distribute_tensor

    ctx = ShardingContext(mesh, rules)
    return map_axes(lambda axes, t: distribute_tensor(
        t, mesh, placements(spec_for(axes, t.shape, ctx), mesh)), axes_tree, tree)
