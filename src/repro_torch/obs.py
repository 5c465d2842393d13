"""Spans at the port's layer boundaries, kept in a bounded in-memory ring.

``span(name, parent=None, **attrs)`` times a block with
``time.perf_counter_ns`` and, when the block ends, appends one
:class:`Record` to the ring: its id, its parent's id, its name, the thread
that ran it, its start and end, and its attributes. The parent is the
innermost span open on the same thread; a span opened on a pool thread or on
the checkpoint reconciler's thread names its parent explicitly (or is a
root). Counters are attributes of the span at whose boundary they are
counted: passed when it opens, set on the yielded :class:`Span` while it
runs, or summed into the innermost open span of the thread with :func:`add`
by code that does not hold it.

Only while ``torch.profiler`` runs does a span also enter
``torch.profiler.record_function(name)``, so that the spans of the thread
that started the profiler stand in its trace over the kernels they launched
(``Record.traced`` says a span did). ``record_function`` costs ~15 us a call
even with no profiler running; a span alone costs a few microseconds. The ring
is always on and holds the last :data:`RING_SIZE` spans of the process;
:func:`spans` reads it.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from contextlib import ExitStack, contextmanager
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

RING_SIZE = 65536


class Record(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    thread: int                # threading.get_ident() of the thread that ran it
    t0: int                    # time.perf_counter_ns() at its start
    t1: int                    # and at its end
    attrs: Dict[str, Any]
    traced: bool               # also entered torch.profiler.record_function

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


class Span:
    """An open span. Its ``attrs`` take counters while it runs; once it has
    closed, ``seconds`` is its length."""

    __slots__ = ("id", "parent", "name", "attrs", "t0", "t1")

    def __init__(self, name: str, parent: Optional[int], attrs: Dict[str, Any]):
        self.id = next(_ids)
        self.parent = parent
        self.name = name
        self.attrs = attrs
        self.t0 = self.t1 = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


_ring: deque = deque(maxlen=RING_SIZE)
_ids = itertools.count(1)
_local = threading.local()


def _open_spans() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled


@contextmanager
def span(name: str, parent: Optional[Span] = None, **attrs) -> Iterator[Span]:
    """Record the block as span ``name``; yields the open :class:`Span`."""
    stack = _open_spans()
    if parent is None and stack:
        parent = stack[-1]
    s = Span(name, parent.id if parent is not None else None, attrs)
    traced = _profiling()
    stack.append(s)
    s.t0 = time.perf_counter_ns()
    try:
        if traced:
            with torch.profiler.record_function(name):
                yield s
        else:
            yield s
    finally:
        s.t1 = time.perf_counter_ns()
        stack.pop()
        _ring.append(Record(s.id, s.parent, name, threading.get_ident(), s.t0, s.t1,
                            s.attrs, traced))


@contextmanager
def on_demand(name: str, **attrs) -> Iterator[Callable[[], Span]]:
    """A span that opens only when the block calls the function it yields
    (the first call opens it, each call returns it), and closes with the
    block: for a pass that may find no work and should then record nothing."""
    with ExitStack() as stack:
        opened: List[Span] = []

        def open_span() -> Span:
            if not opened:
                opened.append(stack.enter_context(span(name, **attrs)))
            return opened[0]

        yield open_span


def add(**counts) -> None:
    """Add each count to the attribute of that name of the innermost span
    open on this thread; nothing where none is open."""
    stack = _open_spans()
    if stack:
        attrs = stack[-1].attrs
        for k, v in counts.items():
            attrs[k] = attrs.get(k, 0) + v


def spans() -> List[Record]:
    """The ring's records, oldest end first."""
    return list(_ring)
