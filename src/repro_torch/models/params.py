"""Parameter construction and the weight bridge to the reference's flat paths.

Model ``init`` functions are written once against a :class:`ParamBuilder`,
as in ``repro.models.params``, and name each leaf by its key in the returned
dicts (the reference's ParamBuilder scopes only feed its per-path RNG, which
the port does not reproduce). A ParamBuilder runs in one of three modes:

* ``init``  — materialise tensors on the target device from a seeded
  ``torch.Generator``, with the reference's scale rules;
* ``axes``  — return the same tree of *logical axis* tuples, one name (or
  ``None``) per dim, which ``repro_torch.parallel.sharding`` maps onto a mesh;
* ``shape`` — return :class:`ParamSpec` stand-ins (no allocation).

All three trees come from one traversal, so they cannot drift apart.

The reference folds a hash of each path into ``jax.random``; the port does
not try to reproduce those numbers. To hold the port against the reference,
:func:`params_from_flat` loads the reference's own weights from the flat
``{path: ndarray}`` dict that ``repro.core.tce.engine.flatten_pytree`` gives,
and :func:`flatten_params` gives the same paths back.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Axes = Tuple[Optional[str], ...]


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return DTYPES[name]


@dataclass(frozen=True)
class ParamSpec:
    """Shape-mode leaf: what ``init`` mode would allocate."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"
    scale: float = 1.0

    def meta(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A meta tensor of this shape (in ``dtype``, else the leaf's own)."""
        return torch.empty(self.shape, dtype=dtype or self.dtype, device="meta")


# --------------------------------------------------------------------------- #
# Nested-dict trees
# --------------------------------------------------------------------------- #
def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs with '/'-joined paths, dict keys sorted as jax does."""
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else str(key)
        sub = tree[key]
        if isinstance(sub, dict):
            yield from tree_items(sub, path)
        else:
            yield path, sub


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def flatten_params(params) -> Dict[str, Any]:
    """``{path: leaf}`` with the reference's ``flatten_pytree`` path names."""
    return dict(tree_items(params))


def tree_like(template, flat: Dict[str, Any], prefix: str = "") -> dict:
    """``template``'s nested dicts with each leaf taken from ``flat`` by its
    path. Unlike :func:`unflatten` it keeps the empty sub-trees that
    ``tree_items`` skips (the parameter-free ``nonparam_ln`` norms). (A plain
    recursion: a nested function that calls itself would hold ``flat``, a
    step's gradients, in a reference cycle until the garbage collector ran.)"""
    return {k: tree_like(v, flat, f"{prefix}{k}/") if isinstance(v, dict) else flat[prefix + k]
            for k, v in template.items()}


def unflatten(flat: Dict[str, Any]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


# --------------------------------------------------------------------------- #
# Builder
# --------------------------------------------------------------------------- #
class ParamBuilder:
    """Builds a nested-dict parameter tree in ``init``, ``axes`` or ``shape`` mode."""

    def __init__(self, mode: str, generator: Optional[torch.Generator] = None,
                 device: torch.device | str = "cpu",
                 param_dtype: torch.dtype = torch.float32):
        if mode not in ("init", "axes", "shape"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "init" and generator is None:
            raise ValueError("init mode needs a torch.Generator")
        self.mode = mode
        self.generator = generator
        self.device = torch.device(device)
        self.param_dtype = param_dtype

    def param(self, shape: Sequence[int], axes: Axes, init: str = "normal",
              scale: float = 1.0, dtype: Optional[torch.dtype] = None):
        """One leaf of ``shape`` whose dims carry the logical ``axes``."""
        if init not in ("normal", "zeros", "ones", "embed"):
            raise ValueError(f"unknown init {init!r}")
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} vs shape {shape}")
        if self.mode == "axes":
            return tuple(axes)
        spec = ParamSpec(shape, dtype or self.param_dtype, init, scale)
        return spec if self.mode == "shape" else self.draw(spec)

    def draw(self, spec: ParamSpec) -> torch.Tensor:
        """One leaf: drawn in float32, then cast to its dtype."""
        shape = spec.shape
        if spec.init == "zeros":
            return torch.zeros(shape, dtype=spec.dtype, device=self.device)
        if spec.init == "ones":
            return torch.ones(shape, dtype=spec.dtype, device=self.device)
        x = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        if spec.init == "normal":
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            x.mul_(spec.scale / math.sqrt(max(fan_in, 1)))
        else:  # embed
            x.mul_(spec.scale)
        return x.to(spec.dtype)


def stacked(pb: ParamBuilder, n: int, fn: Callable[[ParamBuilder], dict]) -> dict:
    """Build ``n`` stacked copies of a sub-tree (leading 'layers' axis).

    In ``init`` mode the stacked leaves are allocated once in their final
    dtype and filled layer by layer, so no float32 copy of a whole stack
    exists at any time; each layer's leaves keep their own fan-in.
    """
    if pb.mode == "axes":
        return tree_map(lambda a: ("layers",) + a, fn(pb))
    mode, pb.mode = pb.mode, "shape"
    try:
        one = fn(pb)
    finally:
        pb.mode = mode
    if mode == "shape":
        return tree_map(lambda s: ParamSpec((n,) + s.shape, s.dtype, s.init, s.scale), one)
    out = tree_map(lambda s: torch.empty((n,) + s.shape, dtype=s.dtype,
                                         device=pb.device), one)
    leaves = list(tree_items(one))
    flat_out = flatten_params(out)
    for i in range(n):
        for path, spec in leaves:
            flat_out[path][i].copy_(pb.draw(spec))
    return out


# --------------------------------------------------------------------------- #
# Weight bridge
# --------------------------------------------------------------------------- #
def params_from_flat(flat: Dict[str, np.ndarray], cfg, device) -> dict:
    """Load the reference's flat weights (``flatten_pytree(init_params(...))``).

    Raises on a missing key, an extra key, a wrong shape or a wrong dtype.
    """
    from .model import param_shapes

    shapes = param_shapes(cfg)
    want = flatten_params(shapes)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"flat params do not match {cfg.name}: "
                       f"missing {missing}, extra {extra}")
    want_np = np.dtype(cfg.param_dtype)
    out = {}
    for path, spec in want.items():
        arr = np.asarray(flat[path])
        if tuple(arr.shape) != spec.shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, want {spec.shape}")
        if arr.dtype != want_np:
            raise ValueError(f"{path}: dtype {arr.dtype}, want {want_np}")
        out[path] = torch.from_numpy(np.array(arr, order="C")).to(device)
    return tree_like(shapes, out)
