"""Zero-overhead user integration (paper §V-C).

The paper's TCE ships as ``pip install transom-checkpoint-engine`` + one
import, monkey-patching DeepSpeed's save path. The equivalent here is a
step-function wrapper: ``transom_protect`` makes any ``step_fn(state, step)``
checkpoint asynchronously every N steps and restore itself transparently on
construction — user training code is otherwise unchanged. Counterpart of
``repro.core.tce.patch``; a restored state's tensors land on the template's
device.

    step_fn = transom_protect(step_fn, tce, every=100)
    for step in range(start_step(tce), total):
        state = step_fn(state, step)
"""
from __future__ import annotations

from typing import Callable, Optional

from .engine import TCEngine, unflatten_like


def start_step(tce: TCEngine, default: int = 0) -> int:
    """Step to resume from (latest recoverable checkpoint, else default)."""
    try:
        step, _ = tce.restore()
        return int(step)
    except FileNotFoundError:
        return default


def restore_into(tce: TCEngine, template):
    """Restore the latest checkpoint into a pytree shaped like `template`;
    returns (step, state) or (0, template) when nothing is recoverable."""
    try:
        step, flat = tce.restore()
        return int(step), unflatten_like(template, flat)
    except FileNotFoundError:
        return 0, template


def transom_protect(step_fn: Callable, tce: TCEngine, *, every: int = 100,
                    on_save: Optional[Callable] = None) -> Callable:
    """Wrap step_fn(state, step) -> state with async TCE checkpointing."""

    def wrapped(state, step: int):
        new_state = step_fn(state, step)
        if (step + 1) % every == 0:
            handle = tce.save(step + 1, new_state)
            if on_save is not None:
                on_save(handle)
        return new_state

    return wrapped
