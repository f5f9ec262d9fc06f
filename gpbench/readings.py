"""What a metric's reader is given: ``Context``, and the readers and the
arithmetic that several metrics share.  A reader is ``read(ctx) -> float
| None``; None means that it found nothing to read in this cell, and the
metric is left out of the result line."""

from __future__ import annotations

import dataclasses
import statistics

import torch

from gpbench import counts


@dataclasses.dataclass
class Window:
    """The measured window: its start, and (call, done) host times of each
    step that completed before its deadline."""

    t0: float
    completed: list

    @property
    def seconds(self) -> float:
        """From the window's start to the end of the last step completed."""
        return self.completed[-1][1] - self.t0 if self.completed else float("nan")

    @property
    def latencies(self) -> list:
        return [done - call for call, done in self.completed]


@dataclasses.dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    seed: int
    setup_s: float
    window: Window
    window_peak_bytes: int | None  # None where no card measured it
    trace: dict | None  # trace.profile_steps' summary, in --trace 1 runs on the card
    program: object  # gpbench.program.Program, alive until the readers are done
    model: object  # the configuration's models/<model>.py

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    @property
    def on_card(self) -> bool:
        return self.program.x.is_cuda

    def steps_per_s(self) -> float | None:
        return len(self.window.completed) / self.window.seconds if self.window.completed else None

    def cuda_seconds(self, fn) -> float | None:
        """Median seconds a call of ``fn`` on the card by CUDA events, over
        3 batches of back-to-back calls (about 0.2 s each) after a warm-up
        call; None off the card."""
        if not self.on_card:
            return None
        fn()
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        batch = max(1, min(20, int(0.2e3 / max(start.elapsed_time(stop), 1e-3))))
        times = []
        for _ in range(3):
            start.record()
            for _ in range(batch):
                fn()
            stop.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(stop) / batch * 1e-3)
        return statistics.median(times)


def roofline_pct(ctx: Context, fn, nbytes: float, flops: float) -> float | None:
    """The share of its roofline bound that ``fn`` reaches on the card."""
    seconds = ctx.cuda_seconds(fn)
    if seconds is None:
        return None
    return 100.0 * counts.roofline_s(nbytes, flops)[0] / seconds


def mfu_pct(ctx: Context, flops_per_step: float) -> float | None:
    """The window's counted operations a second over the TF32 peak."""
    rate = ctx.steps_per_s()
    return None if rate is None or not ctx.on_card else 100.0 * flops_per_step * rate / counts.TF32_FLOP_PER_S


def idle_pct(ctx: Context) -> float | None:
    """The share of the traced span in which no operation ran on the card."""
    if ctx.trace is None or ctx.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])


PANEL = 1024  # the blocked factorization's panel


def tune_rate(ctx: Context) -> float | None:
    """Tuning steps completed in the window a second."""
    return ctx.steps_per_s() if ctx.kind == "tune" else None


def tune_mfu(ctx: Context) -> float | None:
    if ctx.kind != "tune":
        return None
    return mfu_pct(ctx, ctx.model.value_grad_flops(ctx.config, ctx.traffic["objective"]))


def tune_idle(ctx: Context) -> float | None:
    return idle_pct(ctx) if ctx.kind == "tune" else None


def tune_launches(ctx: Context) -> float | None:
    """Kernels launched a tuning step in the traced span."""
    if ctx.kind != "tune" or ctx.trace is None or not ctx.trace["launches"]:
        return None
    return ctx.trace["launches"] / ctx.trace["steps"]


def tune_gram_roofline(ctx: Context) -> float | None:
    return roofline_pct(ctx, *ctx.model.training_gram(ctx.program)) if ctx.kind == "tune" else None


def tune_panel_roofline(ctx: Context) -> float | None:
    if ctx.kind != "tune":
        return None
    return roofline_pct(ctx, ctx.program.panel(PANEL, ctx.seed), *counts.panel_bytes_flops(PANEL))
