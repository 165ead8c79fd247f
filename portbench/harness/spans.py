"""The harness's spans around the program's layer calls, and the capture of
what each call produced.

``wrap`` replaces an attribute (a bound method of one object, or a
module-level function that the program looks up at call time) by a
wrapper that opens the span ``portbench:<name>`` while a traced window is
on, and hands the call's arguments and result to ``after``.  The program
itself is not edited.
"""

from __future__ import annotations

import contextlib
import functools

from portbench.harness.trace import SPAN_PREFIX

TRACING = [False]


def span(name: str):
    if not TRACING[0]:
        return contextlib.nullcontext()
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


def wrap(owner, attr: str, name: str | None, after=None):
    """Wrap ``owner.attr``; returns a function that puts the original
    back."""
    orig = getattr(owner, attr)

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        if name is None:
            out = orig(*args, **kwargs)
        else:
            with span(name):
                out = orig(*args, **kwargs)
        if after is not None:
            after(args, kwargs, out)
        return out

    setattr(owner, attr, wrapper)
    return lambda: setattr(owner, attr, orig)
