"""Wall-clock spans and counters of the port, on ``torch.profiler``'s
clock: where the host's time goes inside a served batch, and what each
set-up step took.

    with span("stage0"):              # or @span("stage0") on a function
        ...
        count("postings", work)       # work: an int or a device tensor
    x = to_card(terms, device)        # every host -> card copy of a serve
    y = to_host(scores).numpy()       # every card -> host copy of a serve
    with phase("setup.index"):        # once a process, always recorded
        ...

A span is on exactly while a ``torch.profiler`` records (the profiler's own
flag, ``torch.autograd.profiler._is_profiler_enabled``); there is no other
switch.  Off, ``span`` reads that flag and returns a shared do-nothing
context, ``count`` reads it and returns, and the copy helpers are the plain
copies.  On, a span stamps ``time.time_ns()`` (the clock the profiler's
events are converted to) at entry and exit, keeps ``(start_ns, end_ns,
name, id, parent, batch, counts)`` in a bounded ring, and opens the
function-scope profiler event ``repro_torch:<name>`` beside the operations
it launches.  A user-scope event (``torch.profiler.record_function``)
would also be copied onto the device's timeline over every kernel it
launched, which a reader of the trace would take for device work; a
function-scope event is not.

``batch`` is a sequence number that the root span ``serve`` draws; the
spans nested under it carry it.  A tensor handed to ``count`` is kept by
reference and summed on the host only when ``records`` reads it, so
counting adds no device operation and no wait inside the traced window.
Phases (``phase``) are kept apart from the ring and never evicted.  The
ring and the phases are the process's, as the profiler is; each thread
nests its own spans.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _prof

PREFIX = "repro_torch:"
ROOT = "serve"
RING = 1 << 16
PHASES = 1 << 12


class HostSpan(NamedTuple):
    start_ns: int
    end_ns: int
    name: str
    id: int
    parent: int | None       # the enclosing span's id
    batch: int | None        # the enclosing ``serve``'s sequence number
    counts: dict             # {name: total}


class Phase(NamedTuple):
    start_ns: int
    end_ns: int
    name: str


_ring: collections.deque = collections.deque(maxlen=RING)
_dropped = [0]
_phases: list[Phase] = []
_open = threading.local()             # each thread's stack of open spans
_ids = itertools.count()
_batches = itertools.count()


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _Span:
    """An open span while a profiler records."""

    __slots__ = ("name", "id", "parent", "batch", "start_ns", "end_ns",
                 "counts", "_event")

    def __init__(self, name: str):
        self.name = name
        self.counts = None

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        self.batch = None if up is None else up.batch
        if self.name == ROOT and self.batch is None:
            self.batch = next(_batches)
        stack.append(self)
        self.start_ns = time.time_ns()
        self._event = torch._C._profiler._RecordFunctionFast(
            PREFIX + self.name)
        self._event.__enter__()
        return self

    def __exit__(self, *exc):
        self._event.__exit__(*exc)
        self.end_ns = time.time_ns()
        self._event = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        if len(_ring) == RING:
            _dropped[0] += 1
        _ring.append(self)
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _Off:
    """A span while no profiler records: does nothing."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _OffSpans(dict):
    def __missing__(self, name):
        off = self[name] = _Off(name)
        return off


_off = _OffSpans()


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not _prof._is_profiler_enabled:
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)
    return spanned


def span(name: str):
    """The span ``name``: a context manager, or a decorator of a function
    whose every call it spans.  Off unless a profiler records."""
    if not _prof._is_profiler_enabled:
        return _off[name]
    return _Span(name)


def count(name: str, n) -> None:
    """Add ``n`` (a number, or a tensor summed when read) to the innermost
    open span's count ``name``; nothing unless a profiler records."""
    if not _prof._is_profiler_enabled:
        return
    stack = _stack()
    if not stack:
        return
    top = stack[-1]
    if top.counts is None:
        top.counts = {}
    top.counts.setdefault(name, []).append(n)


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied to the host (``t.cpu()``), inside a ``sync.d2h`` span
    while a profiler records."""
    if not _prof._is_profiler_enabled:
        return t.cpu()
    with _Span("sync.d2h"):
        return t.cpu()


def to_card(a, device) -> torch.Tensor:
    """``a`` (an array or a tensor) on ``device`` (``torch.as_tensor``),
    inside a ``sync.h2d`` span while a profiler records."""
    if not _prof._is_profiler_enabled:
        return torch.as_tensor(a, device=device)
    with _Span("sync.h2d"):
        return torch.as_tensor(a, device=device)


@contextlib.contextmanager
def phase(name: str):
    """A set-up step, recorded whether or not a profiler records (a
    context manager or a decorator); the first ``PHASES`` of a process are
    kept."""
    start = time.time_ns()
    try:
        yield
    finally:
        if len(_phases) < PHASES:
            _phases.append(Phase(start, time.time_ns(), name))


def _total(values) -> int | float:
    return sum(v.sum().item() if isinstance(v, torch.Tensor) else v
               for v in values)


def records() -> list[HostSpan]:
    """The spans in the ring, oldest first, their counts summed (a
    tensor's on the host, once)."""
    out = []
    for s in _ring:
        counts = {}
        if s.counts:
            for k, v in s.counts.items():
                if len(v) != 1 or isinstance(v[0], torch.Tensor):
                    v[:] = [_total(v)]
                counts[k] = v[0]
        out.append(HostSpan(s.start_ns, s.end_ns, s.name, s.id, s.parent,
                            s.batch, counts))
    return out


def phases() -> list[Phase]:
    """Every phase of the process, in the order they ended."""
    return list(_phases)


def dropped() -> int:
    """Spans evicted from the ring since the last ``reset``."""
    return _dropped[0]


def reset() -> None:
    """Forget every span and phase."""
    _ring.clear()
    _phases.clear()
    _dropped[0] = 0
