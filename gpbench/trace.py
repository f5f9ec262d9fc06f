"""The traced span of a ``--trace 1`` run, read from ``torch.profiler``.

A short steady span of the cell's own steps runs under the profiler after
the measured window.  Nothing is written to disk: the profiler's raw
events are reduced in memory to the device's busy time (the union of every
kernel, copy and set on the card), the span's length, the kernel launches,
the device operations that took most time and the longest idle gaps, each
gap named by the innermost host operation that was running across its
middle.  The raw events are read without building the profiler's Python
event tree, which takes minutes for a step of many launches (the sparse
GP's QR).
"""

from __future__ import annotations

import time

import numpy as np
import torch

SPAN = "gpbench.traced_steps"
TOP = 10
GAPS_NAMED = 200  # the longest gaps get a name; the shorter ones count as "shorter gaps"


def _is_launch(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def profile_steps(run_step, count: int) -> dict:
    """Run ``run_step(k)`` for k < count under the profiler; the summary
    of what the card did in that span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(SPAN):
            for k in range(count):
                run_step(k)
            torch.cuda.synchronize()
    t = time.perf_counter()
    cuda, host, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        row = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if row[0] != SPAN:  # the profiler mirrors the span's label onto the card's timeline
                cuda.append(row)
        elif row[0] == SPAN:
            span = row
        else:
            host.append(row)
    if span is None:
        raise RuntimeError(f"the profiler recorded no {SPAN!r} span")
    summary = summarise(span[1], span[2], cuda, host, count)
    summary["reduce_s"] = time.perf_counter() - t
    return summary


def _union(intervals: np.ndarray) -> tuple[np.ndarray, float]:
    """(merged intervals, their total length) of (start, end) rows."""
    intervals = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(intervals[:, 1])
    # a merged interval starts where a start lies past every end before it
    new = np.concatenate([[True], intervals[1:, 0] > ends[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:] - 1, [len(intervals) - 1]])
    merged = np.stack([intervals[first, 0], ends[last]], axis=1)
    return merged, float(np.sum(merged[:, 1] - merged[:, 0]))


def summarise(t0: int, t1: int, cuda: list, host: list, steps: int) -> dict:
    """busy_s, window_s, launches, device_ops and idle_gaps of the span
    [t0, t1] (nanoseconds) from (name, start, end) rows of the card's
    operations and of the host's."""
    out = {"steps": steps, "window_s": (t1 - t0) * 1e-9, "busy_s": 0.0, "launches": 0,
           "device_ops": [], "idle_gaps": []}
    cuda = [row for row in cuda if row[2] > row[1]]
    if not cuda:
        return out
    out["launches"] = sum(1 for row in cuda if _is_launch(row[0]))
    by_name: dict[str, float] = {}
    for name, start, end in cuda:
        by_name[name] = by_name.get(name, 0.0) + (end - start) * 1e-9
    out["device_ops"] = [[name[:120], s] for name, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]
    intervals = np.clip(np.array([[start, end] for _, start, end in cuda], dtype=np.float64), t0, t1)
    intervals = intervals[intervals[:, 1] > intervals[:, 0]]
    if not len(intervals):
        return out
    merged, busy = _union(intervals)
    out["busy_s"] = busy * 1e-9
    edges = np.concatenate([[t0], merged.ravel(), [t1]]).reshape(-1, 2)  # (gap start, gap end) rows
    out["idle_gaps"] = _name_gaps(edges[edges[:, 1] > edges[:, 0]], host)
    return out


def _name_gaps(gaps: np.ndarray, host: list) -> list:
    """Idle seconds summed by the innermost host operation running across
    each long gap's middle: the latest to start among those covering it."""
    if not len(gaps):
        return []
    host = sorted(host, key=lambda row: row[1])
    starts = np.array([row[1] for row in host], dtype=np.float64)
    ends = np.array([row[2] for row in host], dtype=np.float64)
    lengths = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-lengths)
    totals: dict[str, float] = {}
    for g in order[:GAPS_NAMED]:
        mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
        k = int(np.searchsorted(starts, mid, side="right"))
        covering = np.nonzero(ends[:k] >= mid)[0]
        name = host[covering[-1]][0] if len(covering) else "no host operation"
        totals[name] = totals.get(name, 0.0) + float(lengths[g]) * 1e-9
    if len(order) > GAPS_NAMED:
        totals["shorter gaps"] = float(np.sum(lengths[order[GAPS_NAMED:]])) * 1e-9
    return [[name[:120], s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
