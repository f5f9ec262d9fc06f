"""Where the card's time goes inside the program: the port's layer spans.

The port (``albatross_tpu_torch.utils.profiling``) opens a span, named
``albatross.<layer>``, at each layer boundary of its steps: the NLML, the
factorization with its panel, panel solve, trailing update and whitening,
the triangular inverse, the gram, the solves, the leave-one-out folds,
blocks and scores, the sparse GP's components and QR.  Its spans are off
unless turned on, and ``trace.py``'s profiled span runs with them off, so
they add nothing to the rows that the other readers count.

Once a ``--trace 1`` run, the first reader of this module builds the cell's
loop again on the live program and runs ``max(3, ceil(2 s / step))`` steps
under ``torch.profiler`` with the port's spans on
(``albatross_tpu_torch.utils.profiling.spans()``), inside a label of its
own, ``gpbench.port_spans``.  The spans are host events of the profiler's
trace, on the clock that Kineto aligns with the card's CUPTI timeline.  The
raw events are reduced in memory, without the profiler's Python event tree,
and the summary is kept for the run's other readers; the spans are off
again once the block ends.

Attribution, by the rules below; every figure is divided by the count of
root spans (one a tuning step, one a predict batch):

* a kernel or copy on the card belongs to the port spans that were open on
  its launching thread when its runtime call (``cudaLaunchKernel`` and the
  like, found by ``correlation_id``, else by ``linked_correlation_id``)
  started;
* a launch inside a backward node (``autograd::engine::evaluate_function:
  ...``) belongs besides to the spans of that node's forward op, found by
  the node's ``sequence_nr`` on its ``fwd_thread_id``: backward work of
  plain torch ops counts to the forward span it came from, and a custom
  Function's backward, which opens its forward's span again, sits under
  the forward's parents too;
* the card's mirrors of the host's labels (user annotations, or rows named
  as a port span or a ``gpbench.`` label) are neither busy time nor
  launches;
* an idle gap of the card (no kernel, copy or set running, inside the
  label) belongs to the innermost port span that covers its middle on any
  host thread (by the same lineage in a backward node), or else to
  "outside the port".

A span's device time is the sum of the durations of the rows under it
(inclusive: a row counts to every span open above it), its launches the
rows that are not copies or sets.  ``gpbench/metrics/*`` read these
figures through ``device_ms``, ``launches`` and ``port_idle_ms``.  The
whole summary, per span, goes to standard error.
"""

from __future__ import annotations

import bisect
import math
import sys
import time
import weakref
from collections import defaultdict
from typing import NamedTuple

import numpy as np

LABEL = "gpbench.port_spans"
PREFIX = "albatross."
ROOTS = ("albatross.gp.log_likelihood", "albatross.sparse.log_likelihood", "albatross.cv.loo",
         "albatross.gp.predict")
BACKWARD = "autograd::engine::evaluate_function: "
SPAN_S = 2.0  # the profiled span: at least this long and 3 steps
OUTSIDE = "outside the port"
TOP = 8  # the device operations outside the port that the summary names


class Row(NamedTuple):
    """One raw profiler event, as the reducer reads it."""

    name: str
    activity: str  # cpu_op, user_annotation, cuda_runtime on the host; gpu_op, gpu_user_annotation on the card
    start: int  # ns, the profiler's clock
    end: int
    thread: int  # the host thread that recorded it (0 on the card)
    seq: int  # autograd's sequence number, -1 for none
    fwd_thread: int  # a backward node's forward thread, 0 otherwise
    corr: int
    linked: int
    on_card: bool


def rows(events) -> list:
    """``Row``s of ``prof.profiler.kineto_results.events()``.  The kind of a
    row is told from the row (the events of some torch versions have no
    ``activity_type``): on the card an annotation or an operation; on the
    host an annotation, a CUDA API call (named ``cu...``) or an op."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        name, on_card, annotation = e.name(), e.device_type() == cuda, e.is_user_annotation()
        if on_card:
            kind = "gpu_user_annotation" if annotation else "gpu_op"
        else:
            kind = "user_annotation" if annotation else "cuda_runtime" if name.startswith("cu") else "cpu_op"
        out.append(Row(name, kind, e.start_ns(), e.end_ns(), e.start_thread_id(), e.sequence_nr(),
                       e.fwd_thread_id(), e.correlation_id(), e.linked_correlation_id(), on_card))
    return out


def _is_mirror(row: Row) -> bool:
    return row.activity == "gpu_user_annotation" or row.name.startswith((PREFIX, "gpbench."))


def _is_launch(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


class _Thread:
    """The port spans and backward nodes of one host thread, as states
    between boundaries: ``at(t)`` is (open span names, outer to inner;
    the innermost backward node open, or None; the start of the innermost
    interval open, span or node)."""

    def __init__(self, intervals: list):
        # intervals: (start, end, name, node) with node = (fwd_thread, seq) for a backward node
        bounds = []
        for k, (start, end, _, _) in enumerate(intervals):
            bounds.append((start, 1, -end, k))
            bounds.append((end, 0, -start, k))
        bounds.sort()
        self.times, self.states = [], []
        open_ = []
        for t, kind, _, k in bounds:
            if kind:
                open_.append(k)
            elif k in open_:
                open_.remove(k)
            names = tuple(intervals[i][2] for i in open_ if intervals[i][2] is not None)
            nodes = [i for i in open_ if intervals[i][3] is not None]
            node = intervals[nodes[-1]][3] if nodes else None
            since = intervals[open_[-1]][0] if open_ else None
            self.times.append(t)
            self.states.append((names, node, since))

    def at(self, t: int):
        i = bisect.bisect_right(self.times, t) - 1
        return self.states[i] if i >= 0 else ((), None, None)


def _dedupe(names) -> tuple:
    seen, out = set(), []
    for name in names:
        if name not in seen:
            seen.add(name)
            out.append(name)
    return tuple(out)


class _Index:
    """Host threads, forward ops by (thread, sequence number), runtime
    calls by correlation id."""

    def __init__(self, host: list):
        per_thread = defaultdict(list)
        self.forward, self.runtime, self.spans, self.ops, self.nodes = {}, {}, [], [], {}
        self._ops_by_thread = None
        for r in host:
            if r.name.startswith(PREFIX):
                per_thread[r.thread].append((r.start, r.end, r.name, None))
                self.spans.append(r)
            elif r.name.startswith(BACKWARD):
                node = (r.fwd_thread, r.seq, r.start)
                per_thread[r.thread].append((r.start, r.end, None, node))
                self.nodes[(r.thread, node)] = r.name[len(BACKWARD):][:60]
            elif r.activity == "cuda_runtime":
                self.runtime[r.corr] = r
            else:
                self.ops.append(r)
                if r.seq >= 0:
                    self.forward.setdefault((r.thread, r.seq), []).append(r.start)
        self.seqs = defaultdict(list)  # each thread's recorded sequence numbers, in order
        for (thread, seq), starts in self.forward.items():
            starts.sort()
            self.seqs[thread].append(seq)
        for seqs in self.seqs.values():
            seqs.sort()
        self.threads = {t: _Thread(iv) for t, iv in per_thread.items()}
        self._lineage: dict = {}

    def _forward_start(self, node) -> int | None:
        """When the forward op of a backward node started: the last op
        recorded with the node's sequence number on its forward thread
        before the node ran (ops record the number the next node will take,
        so the op that made the node is the last to start with it).  A node
        that no op recorded (autograd's ``CopySlices`` of an in-place write
        into a slice takes a number of its own) goes to the last op recorded
        with the nearest smaller number: the write that made it."""
        fwd_thread, seq, start = node
        seqs = self.seqs.get(fwd_thread, [])
        for i in range(bisect.bisect_right(seqs, seq) - 1, max(-1, bisect.bisect_right(seqs, seq) - 9), -1):
            starts = self.forward[(fwd_thread, seqs[i])]
            k = bisect.bisect_left(starts, start)
            if k:
                return starts[k - 1]
        return None

    def launcher(self, call: Row) -> str:
        """The innermost host op around a runtime call, and the backward
        node it ran in."""
        if self._ops_by_thread is None:
            self._ops_by_thread = defaultdict(list)
            for r in sorted(self.ops, key=lambda r: r.start):
                self._ops_by_thread[r.thread].append(r)
            self._starts = {t: [r.start for r in ops] for t, ops in self._ops_by_thread.items()}
        ops, t = self._ops_by_thread[call.thread], call.start
        k = bisect.bisect_right(self._starts.get(call.thread, []), t)
        op = next((ops[i].name[:60] for i in range(k - 1, max(-1, k - 200), -1) if ops[i].end >= t), "no host op")
        node = self.nodes.get((call.thread, self.threads[call.thread].at(t)[1])) if call.thread in self.threads else None
        return op if node is None else f"{op} in {node}"

    def stack(self, thread: int, t: int, depth: int = 0) -> tuple:
        """The port spans above host time ``t`` on ``thread``, outer to
        inner, a backward node's forward spans first."""
        state = self.threads.get(thread)
        if state is None:
            return ()
        names, node, _ = state.at(t)
        if node is None or depth > 16:
            return _dedupe(names)
        key = node[:2]
        if key not in self._lineage:
            fwd = self._forward_start(node)
            self._lineage[key] = () if fwd is None else self.stack(node[0], fwd, depth + 1)
        return _dedupe(self._lineage[key] + names)

    def innermost_over(self, t: int) -> tuple:
        """The stack of the thread whose innermost open span or node started
        last before ``t``; () where none is open."""
        best, since = None, None
        for thread, state in self.threads.items():
            names, node, start = state.at(t)
            if (names or node) and (since is None or start > since):
                best, since = thread, start
        return () if best is None else self.stack(best, t)


def summarise(events: list) -> dict:
    """The summary of ``Row``s recorded inside the ``LABEL`` span: steps
    (the root spans), the label's seconds, the card's busy seconds (union)
    and summed row seconds, launches, and per stack of span names (outer to
    inner) its device seconds, launches and idle seconds."""
    label = next((r for r in events if r.name == LABEL and not r.on_card), None)
    if label is None:
        raise RuntimeError(f"the profiler recorded no {LABEL!r} span")
    t0, t1 = label.start, label.end
    host = [r for r in events if not r.on_card and r.name != LABEL]
    card = [r for r in events if r.on_card and not _is_mirror(r) and r.end > r.start]
    index = _Index(host)
    stacks: dict = defaultdict(lambda: [0.0, 0, 0.0])
    outside: dict = defaultdict(float)
    intervals = []
    for r in card:
        start, end = max(r.start, t0), min(r.end, t1)
        if end <= start:
            continue
        intervals.append((start, end))
        # the kernel's own correlation id is its runtime call's; its linked id
        # may be the launching op's, which can equal another call's number
        call = index.runtime.get(r.corr) or index.runtime.get(r.linked)
        key = index.stack(call.thread, call.start) if call is not None else ()
        entry = stacks[key]
        entry[0] += (end - start) * 1e-9
        entry[1] += _is_launch(r.name)
        if not key:
            # what lies outside the port, by operation and by the host op that launched it
            launcher = index.launcher(call) if call is not None else "no runtime call found"
            outside[(r.name[:80], launcher)] += (end - start) * 1e-9
    busy = 0.0
    if intervals:
        merged, busy = _union(np.array(intervals, dtype=np.float64))
        edges = np.concatenate([[t0], merged.ravel(), [t1]]).reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
    else:
        gaps = np.array([[t0, t1]], dtype=np.float64)
    for g0, g1 in gaps:
        stacks[index.innermost_over(int(0.5 * (g0 + g1)))][2] += float(g1 - g0) * 1e-9
    # a root span counts where it is the one root open on its thread at its start
    steps = sum(1 for r in index.spans if r.name in ROOTS
                and sum(name in ROOTS for name in index.threads[r.thread].at(r.start)[0]) == 1)
    return {"steps": steps, "window_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "device_s": sum(v[0] for v in stacks.values()), "launches": sum(v[1] for v in stacks.values()),
            "opened": sorted({r.name for r in index.spans}), "stacks": dict(stacks),
            "outside": sorted(outside.items(), key=lambda kv: -kv[1])[:TOP]}


def _union(intervals: np.ndarray) -> tuple:
    """(merged intervals, their total length) of (start, end) rows."""
    intervals = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(intervals[:, 1])
    new = np.concatenate([[True], intervals[1:, 0] > ends[:-1]])
    first = np.nonzero(new)[0]
    last = np.concatenate([first[1:] - 1, [len(intervals) - 1]])
    merged = np.stack([intervals[first, 0], ends[last]], axis=1)
    return merged, float(np.sum(merged[:, 1] - merged[:, 0]))


def _under(summary: dict, names, column: int) -> float | None:
    """A column summed over the stacks that hold any of ``names``, a step;
    None where no step opened any of them."""
    names = set(names)
    if not summary or not summary["steps"] or not names & set(summary["opened"]):
        return None
    total = sum(v[column] for key, v in summary["stacks"].items() if names & set(key))
    return total / summary["steps"]


def device_ms(summary: dict, *names: str) -> float | None:
    """Device milliseconds a step under any of the spans ``names``."""
    value = _under(summary, names, 0)
    return None if value is None else value * 1e3


def launches(summary: dict, *names: str) -> float | None:
    """Kernels launched a step under any of the spans ``names``."""
    return _under(summary, names, 1)


def port_idle_ms(summary: dict) -> float | None:
    """Milliseconds a step that the card stood idle inside a port span."""
    if not summary or not summary["steps"]:
        return None
    return sum(v[2] for key, v in summary["stacks"].items() if key) / summary["steps"] * 1e3


def table(summary: dict) -> list:
    """(span, device ms, launches, idle ms) a step for each span opened,
    inclusive, then the same of the rows outside every span."""
    out = []
    for name in summary["opened"]:
        out.append((name, device_ms(summary, name), launches(summary, name), _under(summary, [name], 2) * 1e3))
    outside = summary["stacks"].get((), [0.0, 0, 0.0])
    steps = max(1, summary["steps"])
    out.append((OUTSIDE, outside[0] / steps * 1e3, outside[1] / steps, outside[2] / steps * 1e3))
    return out


_MEMO: tuple | None = None  # (weak reference to the run's Context, its summary)


def summary(ctx) -> dict | None:
    """The port spans' summary of the run ``ctx`` (a ``readings.Context``),
    profiled on the first call; None off the card or where no step opened
    a root span."""
    global _MEMO
    if _MEMO is not None and _MEMO[0]() is ctx:
        return _MEMO[1]
    found = _profile(ctx) if ctx.on_card and ctx.window.completed else None
    if found is not None and not found["steps"]:
        found = None
    _MEMO = (weakref.ref(ctx), found)
    return found


def _profile(ctx) -> dict | None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpbench import spec

    try:
        from albatross_tpu_torch.utils.profiling import spans
    except ImportError:  # a program without the port's spans: nothing to read
        return None

    cell = spec.load_cell(ctx.workload)
    loop = cell.kind.Loop(cell, ctx.program, ctx.seed)
    per_step = ctx.window.seconds / len(ctx.window.completed)
    count = max(3, math.ceil(SPAN_S / per_step))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with spans(), record_function(LABEL):
            for k in range(count):
                loop.step(loop.inputs(k))
            torch.cuda.synchronize()
    del loop
    t = time.perf_counter()
    out = summarise(rows(prof.profiler.kineto_results.events()))
    out["reduce_s"] = time.perf_counter() - t
    _log(out, ctx)
    return out


def _log(out: dict, ctx) -> None:
    def log(message):
        print(message, file=sys.stderr, flush=True)

    steps = max(1, out["steps"])
    log(f"port spans: {out['steps']} steps, {out['window_s']:.4f} s, busy {out['busy_s']:.4f} s, "
        f"{out['launches']} launches, reduced in {out['reduce_s']:.2f} s")
    inside = sum(v[0] for key, v in out["stacks"].items() if key)
    if out["device_s"] > 0:
        log(f"port spans: {100.0 * inside / out['device_s']:.2f}% of the card's summed row time lies under a "
            f"port span; idle in the port {port_idle_ms(out):.3f} ms a step, outside "
            f"{out['stacks'].get((), [0, 0, 0.0])[2] / steps * 1e3:.3f} ms a step")
    if ctx.trace is not None and ctx.trace["steps"]:
        off = ctx.trace["steps"] / ctx.trace["window_s"]
        on = out["steps"] / out["window_s"]
        log(f"port spans on: {on:.5f} steps/s against {off:.5f} off in trace.py's span "
            f"({100.0 * (off - on) / off:+.2f}% cost)")
    for (name, launcher), seconds in out["outside"]:
        log(f"port spans: outside the port {seconds / steps * 1e3:.3f} ms a step: {name} (from {launcher})")
    log("port spans: span | device ms | launches | idle ms, a step, inclusive")
    for name, ms, count, idle in table(out):
        log(f"port span {name} | {ms:.3f} | {count:.1f} | {idle:.3f}")
