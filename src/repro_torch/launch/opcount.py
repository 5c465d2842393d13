"""Operation counting for the dry run, on the meta device.

Counterpart of ``repro.launch.hloparse``, which walks a compiled program's
post-SPMD HLO text for per-device dot FLOPs, HBM traffic and collective
bytes. The port compiles no program: it runs the step's function on meta
tensors (shapes and dtypes, no data, no allocation) under
``torch.utils.flop_counter.FlopCounterMode``, which counts every matmul,
einsum (as the bmm it lowers to), bmm, convolution and attention call by its
shapes: ``2*M*N*K`` per product, the backward's products included when the
function takes gradients. That is the step's *global* count; no partitioner
splits it over a mesh and no collective is inserted, so nothing here counts
HBM traffic or collective bytes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn: Callable, *args, **kw) -> Tuple[int, Dict[str, int], object]:
    """(total FLOPs, FLOPs by aten op, fn's result) of one call."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kw)
    by_op = {str(op): int(n) for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return int(counter.get_total_flops()), by_op, out


def _wire_factor(kind: str, n: int) -> float:
    """The ring model's bytes on the wire per result byte of a collective
    over ``n`` ranks (the reference's, kept for a count of the port's own
    collectives; the dry run inserts none)."""
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return float(n - 1)
    if kind == "all-reduce":
        return 2 * (n - 1) / n
    if kind == "all-to-all":
        return (n - 1) / n
    return 1.0
