"""Tracing (port of matfac_tpu/train/profiler.py).

The reference's only tracing is wall-clock per-epoch prints
(modelMF.cpp:126-133, SURVEY.md §5). Here:

* ``trace()``: a ``torch.profiler`` trace around a window, written as a
  Chrome trace;
* ``span()`` / ``request()`` / ``count()``: the program's spans and
  counters at its layer boundaries (the loop's sync and checks, a solver's
  epoch, the ordered scatter, the BPR sampler, the stripe engine's rank
  draw, a serving request's card waits), kept only while a
  ``torch.profiler`` records;
* ``records()`` / ``reset()``: what was kept in this process.

A span rides on the profiler: while one records, it enters
``record_function(name)``, so it sits in the profiler's own event list
and on the timeline of its kernels and copies (a user annotation), and
on exit appends ``Span(name, parent, t0_ns, t1_ns, req)`` to this
process's list, read on the host's monotonic clock
(``time.perf_counter_ns``) inside the annotation. ``parent`` is the name
of the kept span open around it when it opened (None at the root);
``req`` the request number all spans of one request share. A span is
kept only if a profiler recorded at both its entry and its exit: one
that straddles ``start()`` or ``stop()`` is dropped. A span whose body
raises is still closed and kept.

With no profiler recording, ``span`` returns one shared no-op context:
it reads one flag, enters no ``record_function``, reads no clock and
allocates nothing, and ``count`` adds nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_clock = time.perf_counter_ns
_NOOP = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: Optional[str]
    t0_ns: int
    t1_ns: int
    req: Optional[int]


_spans: List[Span] = []
_counts: Dict[str, int] = {}
_open = threading.local()        # .stack: this thread's open kept spans
_request_ids = itertools.count(1)


class _Span:
    __slots__ = ("name", "req", "parent", "rf", "t0")

    def __init__(self, name: str, req: Optional[int]):
        self.name, self.req = name, req

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        up = stack[-1] if stack else None
        self.parent = up.name if up is not None else None
        if self.req is None and up is not None:
            self.req = up.req
        self.rf = record_function(self.name)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        _open.stack.pop()
        self.rf.__exit__(*exc)
        if _autograd_profiler._is_profiler_enabled:
            _spans.append(Span(self.name, self.parent, self.t0, t1,
                               self.req))
        return False


def span(name: str, req: Optional[int] = None):
    """A context that marks ``name`` while a profiler records (see the
    module docstring); ``req`` None takes the enclosing span's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, req)


def request(name: str):
    """The root span of one request: ``span(name, req=n)``, ``n`` this
    process's next request number, drawn only while a profiler records."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, next(_request_ids))


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to this process's counter ``name`` while a profiler
    records."""
    if _autograd_profiler._is_profiler_enabled:
        _counts[name] = _counts.get(name, 0) + n


def records() -> dict:
    """The kept spans (``spans``: a list of ``Span``, in the order they
    closed) and the counters (``counts``: name to total), copies."""
    return dict(spans=list(_spans), counts=dict(_counts))


def reset() -> None:
    """Clear the kept spans and the counters."""
    _spans.clear()
    _counts.clear()


@contextlib.contextmanager
def trace(log_dir: str, device="cuda") -> Iterator[profile]:
    """Profile the host and, on a CUDA ``device``, the card over the
    ``with`` block; on exit the Chrome trace (chrome://tracing, Perfetto)
    is written to ``log_dir/trace_<ms since the epoch>.json``, the path
    kept as the profile's ``trace_path``. The program's spans show in it
    as user annotations."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(log_dir,
                                   f"trace_{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_path)
