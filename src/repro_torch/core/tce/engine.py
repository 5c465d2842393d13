"""Train-state tree <-> flat ``{path: ndarray}`` dict, for the checkpoint datapath.

Counterpart of ``flatten_pytree`` and ``unflatten_like`` in
``repro.core.tce.engine``, for the port's trees (NamedTuples such as
``TrainState``, dicts, lists and tuples of tensors). The path strings are the
reference's: NamedTuple fields by name, dict keys sorted, sequence items by
index, joined with ``/`` (``step``, ``rng``,
``params/segments/stack/l0/mix/wq``, ``opt/m/tok/table/q`` for an int8
moment), so a checkpoint written by either package restores in the other.

numpy has no bfloat16, so a bf16 tensor flattens to its bit pattern in the
codec's :data:`~repro_torch.core.tce.codec.BF16` carrier and comes back bit
for bit. The reference's ``TCEngine`` waits for a later slice of the port.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from .codec import BF16


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if _is_namedtuple(tree):
        kids = [(f, getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), x) for i, x in enumerate(tree)]
    else:
        yield (prefix or "leaf"), tree
        return
    for key, sub in kids:
        yield from _items(sub, f"{prefix}/{key}" if prefix else key)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()
    return np.asarray(leaf)


def flatten_pytree(tree) -> Dict[str, np.ndarray]:
    """Flatten a tree of tensors to {path: np.ndarray} (host copies)."""
    return {path: _to_numpy(leaf) for path, leaf in _items(tree)}


def _like(leaf, arr: np.ndarray):
    if not isinstance(leaf, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype == BF16:
        t = torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    t = t.to(leaf.dtype)
    return t.reshape(leaf.shape).to(leaf.device)


def _rebuild(tree, flat: Dict[str, np.ndarray], prefix: str = ""):
    def path(key):
        return f"{prefix}/{key}" if prefix else key

    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), flat, path(f)) for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], flat, path(str(k))) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, flat, path(str(i))) for i, x in enumerate(tree))
    return _like(tree, flat[prefix or "leaf"])


def unflatten_like(tree, flat: Dict[str, np.ndarray]):
    """Inverse of flatten_pytree given a template tree: each leaf takes the
    template's dtype, shape and device."""
    return _rebuild(tree, flat)
