"""Profiling and tracing helpers: the port's layer spans.

Counterpart of ``albatross_tpu.utils.profiling``.  ``named_scope(name)``
is the port's one span: the port opens one at each layer boundary of its
hot paths (every name starts with ``albatross.``: the NLML, the
factorization and its panel, panel solve, trailing update and whitening,
the gram, one evaluation of a covariance function and its non-Euclidean
metrics, the solves, the leave-one-out folds and blocks, the sparse GP's
components and QR), as a context manager or a decorator.

Spans are **off** by default.  Off, entering and leaving a span reads one
module-level flag and does nothing else: no ``RecordFunction``, no
allocation, no synchronisation, no read-back.  Turn them on for a block
with ``spans()`` (on every thread); ``trace(log_dir)`` turns them on too.
On, a span is ``torch.profiler.record_function(name)``: its start and end
are host events in the profiler's own trace, which Kineto aligns with the
CUPTI device timeline, so the spans and the card's kernels share one clock.
The profiler keeps them in memory; ``trace`` writes them to disk as a
Chrome trace, and a reader of the profiler's events may reduce them in
memory instead.  Kineto also mirrors each span onto the device timeline as
a user annotation: a reader that counts device rows drops those.

Backward work: the port's own ``torch.autograd.Function``s open the span
of their forward in their ``backward``.  Backward work of plain torch ops
opens no span; it belongs to the forward span it came from, which a reader
finds through autograd's sequence number (an ``autograd::engine::
evaluate_function: ...`` event carries its forward op's ``sequence_nr``
and ``fwd_thread_id``).

``wall_timer`` is a host-side wall clock that does not synchronise with
the device, as in the JAX package: it times the enqueue, not the card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from typing import Iterator, Optional

import torch

_ON = False  # whether named_scope records: spans() and trace() set it
_SPANS: dict = {}  # one _Span a name
_OPEN = threading.local()  # each thread's open (span, record_function) pairs


class _Span:
    """One named span, shared by every use of its name: a context manager
    and a decorator.  Open instances live on the entering thread's stack,
    so one span may nest in itself and open on several threads at once.
    Turn spans on or off only where none is open."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if _ON:
            record = torch.profiler.record_function(self.name)
            record.__enter__()
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            stack.append((self, record))
        return self

    def __exit__(self, *exc):
        if _ON:
            stack = _OPEN.stack
            if stack and stack[-1][0] is self:
                stack.pop()[1].__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return spanned


def named_scope(name: str) -> _Span:
    """The span ``name``: ``with named_scope("albatross.solve"): ...`` or
    ``@named_scope("albatross.gp.predict")``.  It records only while spans
    are on (``spans()``, ``trace()``)."""
    span = _SPANS.get(name)
    if span is None:
        span = _SPANS.setdefault(name, _Span(name))
    return span


@contextlib.contextmanager
def spans() -> Iterator[None]:
    """Turn the port's spans on for the block, on every thread, and restore
    the setting before it afterwards:
    ``with torch.profiler.profile(...), spans(): step()``."""
    global _ON
    before, _ON = _ON, True
    try:
        yield
    finally:
        _ON = before


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a trace of the block, the port's spans on, into
    ``log_dir/trace.json`` (viewable in ui.perfetto.dev or
    chrome://tracing): ``with trace("prof"): step()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        with spans():
            yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def wall_timer(label: str, results: Optional[dict] = None) -> Iterator[None]:
    """Host-side wall timer; stores seconds into ``results[label]``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        if results is not None:
            results[label] = elapsed
