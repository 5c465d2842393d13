"""Faults planted in the timed path's place, for the readings that set a
limit's upper end (``control.py``, on the card) and for the tests that see
``correct`` come out false (``test_perfbench_faults.py``, on the CPU)."""
from __future__ import annotations

import contextlib

import torch


def no_carry(scan):
    """``scan`` (an SSD scan: x, dt, A, B, C, chunk, ...) run on each chunk
    alone, so every chunk starts from a zero state: the carry between chunks
    (the inter-chunk recurrence and the starting states' term in the outputs)
    left out. The final state is the last chunk's own."""
    def scan_per_chunk(x, dt, A, B, C, chunk, **kw):
        c = min(chunk, x.shape[1])
        ys, state = [], None
        for i in range(0, x.shape[1], c):
            part = slice(i, i + c)
            y, state = scan(x[:, part], dt[:, part], A, B[:, part], C[:, part], c,
                            **(kw if i == 0 else {}))
            ys.append(y)
        return torch.cat(ys, dim=1), state
    return scan_per_chunk


@contextlib.contextmanager
def patched(owner, name: str, value):
    """``owner.name`` set to ``value`` inside the block."""
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)
