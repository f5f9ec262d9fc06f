"""Profiling and tracing helpers.

Counterpart of ``albatross_tpu.utils.profiling``: ``trace`` records a
``torch.profiler`` trace (CUDA activity too when the card is available)
and writes it as a Chrome trace into a directory; ``named_scope`` labels a
region in such traces (``torch.profiler.record_function``), as a context
manager or a decorator; ``wall_timer`` is a host-side wall clock that does
not synchronise with the device, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a trace of the block into ``log_dir/trace.json`` (viewable in
    ui.perfetto.dev or chrome://tracing): ``with trace("prof"): step()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def named_scope(name: str) -> torch.profiler.record_function:
    """Label a region in profiler traces; a context manager or a decorator."""
    return torch.profiler.record_function(name)


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
