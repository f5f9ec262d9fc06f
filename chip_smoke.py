#!/usr/bin/env python3
"""Drive the PyTorch port's exact-GP main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written CUDA kernels from ``albatross_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the main
path's shapes, then runs the main path through the public API at full
size -- ``log_likelihood`` and ``fit -> predict -> marginal`` of
SquaredExponential(0.5, 1.0) + measurement_only(IndependentNoise(0.3)),
jitter 1e-4, on N = 28672 sorted 1-D f32 inputs on [0, 100] -- checks it
against an f64 plain-PyTorch reference on the card and that every kernel
of the path was launched, and times it.  A short f64 phase at N = 3072
checks that f64 on the card factors its panels as the JAX package does
(torch.linalg.cholesky + blocked_tri_inverse, no panel-kernel launch) and
matches the CPU.  The value+grad phase runs the tuning loop's unit of
work, -log_likelihood and its gradient with respect to the tunable vector
through ``set_tunable_params``: at N = 8192 it is held against an f64
reference on the card that does not use the blocked loop (with a TF32
control that must fail the same gate), its launches and panel backward
calls are counted and it is timed; at N = 28672 it is timed with its peak
memory; a 10-iteration L-BFGS run of ``get_tuner`` at N = 8192 must lower
the objective.  The lazy-gram phases run the memory-lean NLML, where the
gram kernel writes each column panel straight into the factorization's
buffers: its column blocks against the plain version at three panels of
N = 28672; the lazy loop (``CHOLESKY_ALGORITHM = "right_fused"``) against
the materialized one there, and its value+grad at N = 8192 against the
f64 reference; and at N = 57344, above ``CHOLESKY_FUSED_MIN_N``, by the
default route, the forward and value+grad with their launch counts, times
and peak memory, and the f32 NLML against an f64 lazy NLML on the card.
The cross-validation phase holds fast LOO, a LOGO of 128 groups of 64 (the
batched path) and a ragged LOGO at N = 8192 against the same calls in f64
on the card, with a TF32 control, and times LOO at N = 28672.  Any failed
check raises.  Each kernel's time is printed
beside its bound (the least time the card could take for the same work);
the gram kernels also beside the card's write floor, a ``fill_`` of a
buffer of the gram's shape.
``--profile`` adds a torch.profiler breakdown of one NLML's device time and
of one value+grad evaluation's, forward and backward apart, and of one
lazy NLML at N = 57344.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is visible or the port's package is not beside this
script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 28672          # training points (the bench model's size)
N_TEST = 4096      # predict points
SEED = 0
LENGTH_SCALE, SIGMA, NOISE, JITTER = 0.5, 1.0, 0.3, 1e-4
PANELS = 28        # N / 1024: the CUDA panel size at N = 28672
N_F64 = 3072       # the f64 phase: three panels of 1024
N_GRAD = 8192      # the value+grad phase (bench.py's value+grad size)
PANELS_GRAD = 8    # N_GRAD / 1024
REPS = 5
GRAD_REPS = 10     # value+grad evaluations timed at N_GRAD (bench.py times 8)
BIG_GRAD_REPS = 3  # value+grad evaluations timed at N
TUNE_ITERATIONS = 10
N_LAZY = 57344     # the lazy-gram phase: above CHOLESKY_FUSED_MIN_N
PANELS_LAZY = 56   # N_LAZY / 1024
LAZY_REPS = 2      # timed lazy evaluations at N_LAZY (after the counted one)
COL_B = 1024       # column-panel width on the card
COL_J0 = (0, 13312, 27648)  # column panels of N checked against the plain gram
CV_GROUP = 64      # the uniform LOGO: N_GRAD / 64 = 128 groups of 64 sorted points
CV_RAGGED_WIDTH = 0.7  # the ragged LOGO: inputs grouped by floor(x / 0.7)
CV_REPS = 3
# NVIDIA's data sheet for the H100 SXM: device memory rate, and the FP32
# rate outside the tensor cores (the panel kernel and the grams use no
# tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# Tolerances, with their reasons:
# f32 gram vs its plain version: both compute d^2 exactly; they differ only
# in exp / division rounding (a few ulp), so 1e-5 * sigma^2 absolute.
GRAM_F32_TOL = 1e-5
# f64 gram vs plain: the same expressions in f64, a few ulp.
GRAM_F64_TOL = 1e-12
# panel vs f64 LAPACK-style factor: the JAX package's own bounds
# (tests/test_pallas_chol.py), relative to the max entry.
PANEL_U_TOL, PANEL_WU_TOL = 1e-5, 1e-4
# panel kernel vs its plain f32 version (cuSOLVER + GEMM inverse), relative
# to the max entry: each was measured within 4e-7 of f64 on H100, so they
# differ by at most ~8e-7; about 6x that.
PANEL_PLAIN_TOL = 5e-6
# End-to-end gates, about 10x the f32-vs-f64 errors measured on H100 (NLML
# 9.5e-7 relative; predictive mean 7.8e-6, variance 4.3e-7 absolute), so a
# lower-precision factorization (TF32 GEMMs) cannot pass unseen: the TF32
# control below must fail them.
NLML_REL_TOL = 1e-5
PREDICT_MEAN_TOL = 1e-4
PREDICT_VAR_TOL = 5e-6
# f64 on the card against f64 on the CPU: the same algorithm, only the
# summation order of the BLAS differs (about 1e-13 here).
F64_REL_TOL = 1e-9
# value+grad at N_GRAD, f32 against an f64 reference: the value's relative
# error and the gradient's largest error relative to its largest entry,
# about 10x the f32 errors measured on H100 (1.87e-6 and 1.21e-6), so TF32
# GEMMs cannot pass unseen: the TF32 control (value 4.1e-5) must fail them.
GRAD_VALUE_REL_TOL = 2e-5
GRAD_REL_TOL = 1.2e-5
# the lazy and the materialized f32 NLML at N run the same panel, GEMM and
# gram operations in the same order: equal to the last bit is expected.
LAZY_REL_TOL = 1e-6
# cross-validation at N_GRAD, f32 against the same call in f64 on the card,
# each error the largest absolute difference over the largest f64 entry:
# about 10x the first reading on H100 (2.3e-6, 4.4e-6, 8.0e-5, 1.27e-4,
# 2.25e-5, 1.43e-4; the inverse's blocks lose accuracy with the condition
# number), so the TF32 control (2e-3 to 7e-3) fails them.
CV_TOLS = {"loo mean": 2.5e-5, "loo variance": 5e-5, "logo mean": 8e-4, "logo covariance": 1.3e-3,
           "ragged mean": 2.5e-4, "ragged variance": 1.5e-3}

SOURCES = {
    "radial_gram": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:81"),
    "radial_gram_diag": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "panel_cholinv": ("albatross_tpu_torch/csrc/panel_cholinv.cu", "albatross_tpu/ops/pallas_chol.py:121"),
}
PROFILE = "squared_exponential"


def nlml_flops(n: int) -> float:
    """bench.py's count: Cholesky n^3/3 + whitening n^2 + gram 8 n^2."""
    return n**3 / 3.0 + n * n + 8.0 * n * n


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(least milliseconds on the card, what bounds it): the larger of the
    bytes over the memory rate and the FP32 operations over their rate."""
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(by_bytes, by_flops) * 1e3, "bytes" if by_bytes >= by_flops else "operations"


def gram_bound(n: int, m: int, d: int, itemsize: int, square: bool, diag: bool) -> tuple[float, str]:
    """Bound of an (n, m) radial gram: X, and Y unless it is X, and the
    diagonal read once, the output written once; a lower count of its
    operations, 3 a feature and 4 for the profile (divide, negate, exp,
    scale) an element."""
    nbytes = itemsize * (n * m + n * d + (0 if square else m * d) + (n if diag else 0))
    return bound(nbytes, n * m * (3 * d + 4))


def panel_bound(b: int) -> tuple[float, str]:
    """Bound of the f32 panel factor + inverse at block size b: b^2 read,
    2 b^2 written; 2 b^3 / 3 FLOP (b^3 / 3 for the factor, as much for the
    inverse)."""
    return bound(4 * 3 * b * b, 2 * b**3 / 3)


def cols_group_bound(n: int, b: int) -> tuple[float, str]:
    """Bound of one lazy NLML's column launches at D = 1, f32: for each
    panel [j0, j0 + b), X = x[j0:], Y and the diagonal (b long) read once,
    the (n - j0, b) block written once, 7 operations an element; summed,
    about n (n + b) / 2 entries written."""
    nbytes = flops = 0.0
    for j0 in range(0, n, b):
        rows, cols = n - j0, min(b, n - j0)
        nbytes += 4 * (rows * cols + rows + 2 * cols)
        flops += rows * cols * (3 + 4)
    return bound(nbytes, flops)


def ptxas_summary(log: str) -> str:
    """Kernel count, register range and spill bytes from ``-Xptxas -v``."""
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spilled = sum(int(b) for b in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
    if not regs:
        return "no ptxas report"
    return f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers a thread, {spilled} bytes spilled"


def fail(message: str) -> None:
    raise RuntimeError(f"chip_smoke check failed: {message}")


def cuda_ms(torch, fn, reps: int = REPS, batch: int = 10) -> float:
    """Median milliseconds per call of ``fn`` on the card, after one warm-up
    call: CUDA events around ``batch`` back-to-back calls, ``reps`` times.
    The batch keeps the card busy, so a call made of many short launches
    is timed on the device, not by the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / batch)
    return statistics.median(times)


def print_profile(torch, fn, what: str, card: str, evals: int) -> None:
    """Where ``fn``'s device time goes: torch.profiler over ``evals`` calls
    of it, device kernels only, per call, plus the device idle share
    against host wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(evals):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows, device_us = [], 0.0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue  # the host ops that launch kernels would count them twice
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, e.key, e.count))
            device_us += us
    if not rows:
        fail("torch.profiler recorded no device time")
    print(f"[{card}] profile of {evals} x {what}: wall {wall_ms:.1f} ms, device kernels "
          f"{device_us / 1e3:.1f} ms, device idle share {1 - device_us / 1e3 / wall_ms:.4f}")
    for us, key, count in sorted(rows, reverse=True)[:16]:
        print(f"  {us / 1e3 / evals:9.3f} ms/call  {count // evals:5d} launches/call  {key[:100]}")


def bench_model(pt):
    """The bench model: SquaredExponential(0.5, 1.0) +
    measurement_only(IndependentNoise(0.3)), jitter 1e-4."""
    kernel = pt.SquaredExponential(LENGTH_SCALE, SIGMA) + pt.measurement_only(
        pt.IndependentNoise(NOISE, assume_unique=True)
    )
    return pt.gp_from_covariance(kernel, jitter=JITTER)


def bench_data(np, n: int, seed: int):
    """n sorted f32 inputs on [0, 100], targets sin(0.3 x) + 0.1 noise."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, y


def value_grad(torch, model, data):
    """(-log_likelihood, its gradient with respect to the tunable vector x):
    x from ``get_tunable_parameters``, the model from
    ``set_tunable_params(x)``, the gradient by autograd.  Synchronised."""
    x = model.get_tunable_parameters().values.clone().requires_grad_(True)
    value = -model.set_tunable_params(x).log_likelihood(data)
    (grad,) = torch.autograd.grad(value, x)
    torch.cuda.synchronize()
    return value, grad


def reference_value_grad(torch, model, x64, y64, profile: str):
    """value_grad's f64 reference on the card, without the port's blocked
    loop or kernels: the closed-form gram plus the noise and jitter
    diagonal, torch.linalg.cholesky, a triangular solve and autograd."""
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram

    x = model.get_tunable_parameters().values.clone().requires_grad_(True)
    tuned = model.set_tunable_params(x)
    p = {name: param.value for name, param in tuned.get_params().items()}
    noise = p["sigma_independent_noise"]
    diag = torch.zeros(x64.shape[0], dtype=torch.float64, device=x64.device) + (noise * noise + JITTER)
    K = plain_radial_gram(x64, x64, p["squared_exponential_length_scale"],
                          p["sigma_squared_exponential"], profile, diag)
    L = torch.linalg.cholesky(K)
    white = torch.linalg.solve_triangular(L, y64[:, None], upper=False)[:, 0]
    n = x64.shape[0]
    nll = 0.5 * (2.0 * torch.log(L.diagonal()).sum() + white @ white + n * math.log(2 * math.pi))
    value = nll - tuned.prior_log_likelihood().to(nll.device)
    (grad,) = torch.autograd.grad(value, x)
    return value.item(), grad


def grad_errors(value, grad, ref):
    """(value relative error, max |grad error| / max |grad|) against the
    f64 reference; NaN when anything is non-finite."""
    ref_value, ref_grad = ref
    rel = abs(value.item() - ref_value) / abs(ref_value)
    gerr = ((grad.double().cpu() - ref_grad.cpu()).abs().max() / ref_grad.abs().max()).item()
    return rel, gerr


def check_value_grad(torch, np, pt, _build, config, card: str, args) -> dict:
    """The value+grad phase at N_GRAD: the f64 gate and its TF32 control,
    the launch and panel-backward counts, the timing, the same gates on the
    lazy-gram loop, and a short L-BFGS run of the tuner.  Returns the
    counted run's launch and backward counts."""
    from albatross_tpu_torch.evaluation import GaussianProcessNegativeLogLikelihood
    from albatross_tpu_torch.tuning import get_tuner

    x_np, y_np = bench_data(np, N_GRAD, SEED + 2)
    model = bench_model(pt)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)  # the card by default

    _build.reset_launch_counts()
    value, grad = value_grad(torch, model, data)
    counts, backwards = dict(_build.LAUNCHES), dict(_build.BACKWARDS)
    print(f"value+grad N={N_GRAD} f32: launches {counts}, panel backward calls {backwards}")
    if (counts["radial_gram_diag"] != 1 or counts["panel_cholinv"] != PANELS_GRAD or counts["radial_gram"] != 0
            or counts["radial_gram_cols"] != 0 or backwards["panel_cholinv"] != PANELS_GRAD):
        fail(f"value+grad launch counts {counts}, backward calls {backwards}")
    if grad.shape != (3,) or not torch.isfinite(grad).all():
        fail(f"value+grad gradient {grad}")

    x64 = torch.as_tensor(x_np, dtype=torch.float64, device="cuda")
    y64 = torch.as_tensor(y_np, dtype=torch.float64, device="cuda")
    ref = reference_value_grad(torch, model, x64, y64, "squared_exponential")
    errors = grad_errors(value, grad, ref)
    print(f"value+grad N={N_GRAD}: -log_likelihood f32 = {value.item()!r}, f64 = {ref[0]!r}, rel err "
          f"{errors[0]:.3e} (tol {GRAD_VALUE_REL_TOL:g}); gradient f32 = {grad.tolist()}, f64 = "
          f"{ref[1].tolist()}, max err / max |grad| {errors[1]:.3e} (tol {GRAD_REL_TOL:g})")
    if not (errors[0] <= GRAD_VALUE_REL_TOL and errors[1] <= GRAD_REL_TOL):
        fail(f"value+grad disagrees with the f64 reference: {errors}")
    torch.set_float32_matmul_precision("high")
    try:
        tf32_errors = grad_errors(*value_grad(torch, model, data), ref)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"value+grad TF32 control: value rel err {tf32_errors[0]:.3e}, gradient {tf32_errors[1]:.3e}")
    if tf32_errors[0] <= GRAD_VALUE_REL_TOL and tf32_errors[1] <= GRAD_REL_TOL:
        fail(f"the value+grad gate accepts a TF32 factorization: {tf32_errors}")
    print("value+grad TF32 control: the gate rejects it")
    del x64, y64

    # the lazy-gram loop on the same evaluation: the same gates
    config.CHOLESKY_ALGORITHM = "right_fused"
    _build.reset_launch_counts()
    lazy_value, lazy_grad = value_grad(torch, model, data)
    lazy_counts, lazy_backwards = dict(_build.LAUNCHES), dict(_build.BACKWARDS)
    lazy_errors = grad_errors(lazy_value, lazy_grad, ref)
    lazy_times = []
    for _ in range(GRAD_REPS):
        t = time.perf_counter()
        value_grad(torch, model, data)
        lazy_times.append(time.perf_counter() - t)
    config.CHOLESKY_ALGORITHM = "right"
    print(f"lazy value+grad N={N_GRAD} f32: launches {lazy_counts}, panel backward calls {lazy_backwards}; "
          f"-log_likelihood {lazy_value.item()!r}, rel err {lazy_errors[0]:.3e} (tol {GRAD_VALUE_REL_TOL:g}); "
          f"gradient {lazy_grad.tolist()}, max err / max |grad| {lazy_errors[1]:.3e} (tol {GRAD_REL_TOL:g})")
    print(f"[{card}] lazy NLML value+grad N={N_GRAD} f32: "
          f"{statistics.median(lazy_times) * 1e3:.2f} ms/eval (median of {GRAD_REPS}; all {lazy_times})")
    if (lazy_counts["radial_gram_cols"] != PANELS_GRAD or lazy_counts["radial_gram_diag"] != 0
            or lazy_counts["panel_cholinv"] != PANELS_GRAD or lazy_backwards["panel_cholinv"] != PANELS_GRAD):
        fail(f"lazy value+grad launch counts {lazy_counts}, backward calls {lazy_backwards}")
    if not (lazy_errors[0] <= GRAD_VALUE_REL_TOL and lazy_errors[1] <= GRAD_REL_TOL):
        fail(f"lazy value+grad disagrees with the f64 reference: {lazy_errors}")

    value_grad(torch, model, data)  # warm-up
    times = []
    for _ in range(GRAD_REPS):
        t = time.perf_counter()
        value_grad(torch, model, data)
        times.append(time.perf_counter() - t)
    t_eval = statistics.median(times)
    print(f"[{card}] NLML value+grad N={N_GRAD} f32: {1.0 / t_eval:.2f} evals/s ({t_eval * 1e3:.2f} ms/eval, "
          f"median of {GRAD_REPS}; all {times})")

    tune_kernel = (pt.SquaredExponential(0.3, 0.7)
                   + pt.measurement_only(pt.IndependentNoise(NOISE, assume_unique=True)))
    tune_kernel = (tune_kernel
                   .set_param_prior("squared_exponential_length_scale", pt.LogScaleUniformPrior(1e-2, 1e3))
                   .set_param_prior("sigma_squared_exponential", pt.LogScaleUniformPrior(1e-2, 1e3))
                   .set_param_prior("sigma_independent_noise", pt.FixedPrior()))
    tune_model = pt.gp_from_covariance(tune_kernel, jitter=JITTER)
    metric = GaussianProcessNegativeLogLikelihood()
    evaluations = [0]  # objective evaluations so far; per iteration below

    def counted_metric(dataset, m):
        evaluations[-1] += 1
        return metric(dataset, m)

    stamps = []  # host clock at the end of each iteration

    def log_fn(i, x, v):
        stamps.append(time.perf_counter())
        evaluations.append(0)

    t = time.perf_counter()
    # L-BFGS reads every value back anyway, so a chunk of one iteration
    # costs nothing and lets log_fn close each iteration's count
    tuner = get_tuner(tune_model, counted_metric, data, optimizer="lbfgs",
                      max_iterations=TUNE_ITERATIONS, log_fn=log_fn, sync_every=1)
    tuned, result = tuner.tuned_model()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    ls = float(tuned.get_param_value("squared_exponential_length_scale"))
    sg = float(tuned.get_param_value("sigma_squared_exponential"))
    # the first iteration also pays the optimizer's one-time set-up (the
    # first torch.optim optimizer of a process imports torch._dynamo)
    per_iteration = (stamps[-1] - stamps[0]) / (len(stamps) - 1)
    print(f"[{card}] L-BFGS tuning N={N_GRAD} f32, {len(result.history)} iterations: objective "
          f"{result.history[0]:.6g} -> {result.value:.6g}; length scale 0.3 -> {ls:.6g}, sigma 0.7 -> "
          f"{sg:.6g}; {per_iteration:.4f} s/iteration over iterations 2-{len(stamps)}, "
          f"{stamps[0] - t:.3f} s to the end of the first (set-up included), {seconds:.2f} s in all; "
          f"{sum(evaluations)} value+grad evaluations")
    print(f"L-BFGS objective by iteration {result.history}; value+grad evaluations by iteration "
          f"{evaluations[:-1]}, then {evaluations[-1]} for the final value")
    if not (result.value < result.history[0] and math.isfinite(result.value)):
        fail(f"L-BFGS did not lower the objective: {result.history}")
    if not (tuned.params_are_valid() and math.isfinite(ls) and math.isfinite(sg)):
        fail(f"L-BFGS left invalid parameters: length scale {ls}, sigma {sg}")
    if args.profile:
        print_profile(torch, lambda: value_grad(torch, model, data), f"value+grad N={N_GRAD}", card, 2)
    return {"launches": counts, "backwards": backwards}


def time_value_grad_big(torch, model, data, card: str, args) -> None:
    """value+grad at the main path's N: s/eval, TFLOP/s by bench.py's
    3x-forward accounting, and the evaluation's peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    value_grad(torch, model, data)  # warm-up, and the memory reading
    peak = torch.cuda.max_memory_allocated()
    times = []
    for _ in range(BIG_GRAD_REPS):
        t = time.perf_counter()
        value, grad = value_grad(torch, model, data)
        times.append(time.perf_counter() - t)
    if not (math.isfinite(value.item()) and torch.isfinite(grad).all()):
        fail(f"value+grad at N={N} is not finite: {value.item()}, {grad}")
    t_eval = statistics.median(times)
    print(f"[{card}] NLML value+grad N={N} f32: {t_eval:.4f} s/eval (median of {BIG_GRAD_REPS}; all {times}), "
          f"{3.0 * nlml_flops(N) / t_eval / 1e12:.3f} TFLOP/s by bench.py's 3x-forward accounting; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    if args.profile:
        x = model.get_tunable_parameters().values.clone().requires_grad_(True)
        holder = {}

        def forward():
            holder["value"] = -model.set_tunable_params(x).log_likelihood(data)

        def backward():
            torch.autograd.grad(holder.pop("value"), x)

        forward()
        torch.cuda.synchronize()
        print_profile(torch, backward, f"value+grad backward N={N}", card, 1)
        print_profile(torch, forward, f"value+grad forward N={N}", card, 1)
        del holder


def check_f64_path(torch, np, pt, _build, model) -> None:
    """f64 NLML and fit -> predict -> marginal at N_F64 on the card against
    the same in f64 on the CPU; no panel-kernel launch (the kernel is f32,
    as the TPU kernel is)."""
    rng = np.random.default_rng(SEED + 1)
    x = np.sort(rng.uniform(0.0, 100.0, N_F64))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(N_F64)
    xs = np.linspace(0.0, 100.0, 333)
    _build.reset_launch_counts()
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float64)
    ll = model.log_likelihood(on_gpu).item()
    pred = model.fit(on_gpu).predict(torch.as_tensor(xs, device="cuda")).marginal()
    torch.cuda.synchronize()
    launches = _build.LAUNCHES["panel_cholinv"]
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    ll_ref = model.log_likelihood(on_cpu).item()
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    rel = abs(ll - ll_ref) / abs(ll_ref)
    mean_err = (pred.mean.cpu() - ref.mean).abs().max().item()
    var_err = (pred.variance.cpu() - ref.variance).abs().max().item()
    print(f"f64 N={N_F64} on the card vs the CPU: NLML rel err {rel:.3e}, max|mean diff| "
          f"{mean_err:.3e}, max|variance diff| {var_err:.3e} (tol {F64_REL_TOL:g}); "
          f"panel-kernel launches {launches}")
    if not (rel <= F64_REL_TOL and mean_err <= F64_REL_TOL and var_err <= F64_REL_TOL):
        fail(f"f64 on the card disagrees with the CPU: {(rel, mean_err, var_err)}")
    if launches != 0:
        fail(f"an f64 factorization launched the f32 panel kernel {launches} times")


def check_column_blocks(torch, x, diag) -> float:
    """The gram kernel's column blocks (rows j0.. of columns [j0, j0 + b),
    the lazy loop's launch form) at three panels of the main path against
    the plain gram of the same block: bitwise equal at D = 1, and the
    leading diagonal exactly sigma^2 + diag.  Returns the largest
    difference."""
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram, radial_gram_cols

    s32 = torch.tensor(SIGMA, dtype=torch.float32, device=x.device)
    worst = 0.0
    for j0 in COL_J0:
        col = radial_gram_cols(x, j0, COL_B, LENGTH_SCALE, SIGMA, PROFILE, diag)
        ref = plain_radial_gram(x[j0:], x[j0:j0 + COL_B], LENGTH_SCALE, SIGMA, PROFILE, diag[j0:j0 + COL_B])
        err = (col - ref).abs().max().item()
        worst = max(worst, err)
        lead = torch.equal(col[:COL_B].diagonal(), s32 * s32 + diag[j0:j0 + COL_B])
        print(f"gram column block j0={j0} ({N - j0}, {COL_B}) f32: max|kernel - plain| = {err:.3e}, bitwise "
              f"equal {torch.equal(col, ref)}; leading diagonal exactly sigma^2 + diag: {lead}")
        if col.shape != (N - j0, COL_B) or not torch.equal(col, ref):
            fail(f"gram column block at j0={j0} differs from its plain version: {err}")
        if not lead:
            fail(f"gram column block at j0={j0}: leading diagonal is not sigma^2 + diag")
    return worst


def check_lazy_at_main_n(torch, pt, _build, config, model, data, card: str, ll_materialized: float) -> dict:
    """CHOLESKY_ALGORITHM = "right_fused" at the main path's N: the NLML
    against the materialized one, its launches, and the forward and
    value+grad times and peak memory beside the materialized readings."""
    config.CHOLESKY_ALGORITHM = "right_fused"
    _build.reset_launch_counts()
    ll = model.log_likelihood(data).item()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    rel = abs(ll - ll_materialized) / abs(ll_materialized)
    print(f"lazy vs materialized NLML N={N} f32: {ll!r} vs {ll_materialized!r}, rel diff {rel:.3e} "
          f"(tol {LAZY_REL_TOL:g}); launches {counts}")
    if not rel <= LAZY_REL_TOL:
        fail(f"the lazy NLML differs from the materialized one: {rel}")
    if counts["radial_gram_cols"] != PANELS or counts["radial_gram_diag"] != 0 or counts["panel_cholinv"] != PANELS:
        fail(f"lazy NLML launch counts {counts}")
    times = []
    for _ in range(REPS):
        t = time.perf_counter()
        model.log_likelihood(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    torch.cuda.reset_peak_memory_stats()
    value_grad(torch, model, data)
    peak = torch.cuda.max_memory_allocated()
    vg_times = []
    for _ in range(BIG_GRAD_REPS):
        t = time.perf_counter()
        value_grad(torch, model, data)
        vg_times.append(time.perf_counter() - t)
    config.CHOLESKY_ALGORITHM = "right"
    out = {"nlml_s": statistics.median(times), "value_grad_s": statistics.median(vg_times),
           "value_grad_peak_gib": peak / 2**30}
    print(f"[{card}] lazy NLML N={N} f32: {out['nlml_s']:.4f} s/eval (median of {REPS}; all {times}); "
          f"value+grad {out['value_grad_s']:.4f} s/eval (median of {BIG_GRAD_REPS}; all {vg_times}), "
          f"peak device memory {out['value_grad_peak_gib']:.2f} GiB")
    return out


def check_lazy_big(torch, np, pt, _build, config, card: str, args) -> dict:
    """The lazy loop at N_LAZY by the default route (above
    CHOLESKY_FUSED_MIN_N): launch counts, forward and value+grad times and
    peak memory, and the f32 NLML against an f64 lazy NLML on the card from
    the same inputs.  Returns its readings."""
    if not (config.CHOLESKY_FUSED_MIN_N and N <= config.CHOLESKY_FUSED_MIN_N <= N_LAZY):
        fail(f"CHOLESKY_FUSED_MIN_N = {config.CHOLESKY_FUSED_MIN_N} must lie in [{N}, {N_LAZY}]")
    x_np, y_np = bench_data(np, N_LAZY, SEED + 3)
    model = bench_model(pt)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)  # the card by default
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    ll = model.log_likelihood(data).item()
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(_build.LAUNCHES)
    print(f"lazy NLML N={N_LAZY} f32 (default route): {ll!r}; launches {counts}; peak device memory "
          f"{fwd_peak:.2f} GiB")
    if (counts["radial_gram_cols"] != PANELS_LAZY or counts["radial_gram_diag"] != 0
            or counts["panel_cholinv"] != PANELS_LAZY or counts["radial_gram"] != 0):
        fail(f"lazy NLML N={N_LAZY} launch counts {counts}")
    times = []
    for _ in range(LAZY_REPS):
        t = time.perf_counter()
        model.log_likelihood(data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    value, grad = value_grad(torch, model, data)
    vg_times = [time.perf_counter() - t]
    vg_peak = torch.cuda.max_memory_allocated() / 2**30
    vg_counts, vg_backwards = dict(_build.LAUNCHES), dict(_build.BACKWARDS)
    print(f"lazy value+grad N={N_LAZY} f32: launches {vg_counts}, panel backward calls {vg_backwards}; "
          f"peak device memory {vg_peak:.2f} GiB")
    if (vg_counts["radial_gram_cols"] != PANELS_LAZY or vg_counts["radial_gram_diag"] != 0
            or vg_counts["panel_cholinv"] != PANELS_LAZY or vg_backwards["panel_cholinv"] != PANELS_LAZY):
        fail(f"lazy value+grad N={N_LAZY} launch counts {vg_counts}, backward calls {vg_backwards}")
    if not (math.isfinite(value.item()) and grad.shape == (3,) and torch.isfinite(grad).all()):
        fail(f"lazy value+grad N={N_LAZY} is not finite: {value.item()}, {grad}")
    for _ in range(LAZY_REPS):
        t = time.perf_counter()
        value_grad(torch, model, data)
        vg_times.append(time.perf_counter() - t)
    s_eval, vg_eval = statistics.median(times), statistics.median(vg_times)
    print(f"[{card}] lazy NLML N={N_LAZY} f32: {s_eval:.4f} s/eval (median of {LAZY_REPS}; all {times}), "
          f"{nlml_flops(N_LAZY) / s_eval / 1e12:.3f} TFLOP/s by bench.py's nlml_flops")
    print(f"[{card}] lazy NLML value+grad N={N_LAZY} f32: {vg_eval:.4f} s/eval (median of {len(vg_times)}, the "
          f"counted run included; all {vg_times}), {3.0 * nlml_flops(N_LAZY) / vg_eval / 1e12:.3f} TFLOP/s by "
          f"bench.py's 3x-forward accounting; peak device memory {vg_peak:.2f} GiB")
    del value, grad

    # f64 lazy forward on the card from the same inputs
    data64 = pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)
    _build.reset_launch_counts()
    t = time.perf_counter()
    ll64 = model.log_likelihood(data64).item()
    f64_s = time.perf_counter() - t
    rel = abs(ll - ll64) / abs(ll64)
    print(f"lazy NLML N={N_LAZY}: f32 {ll!r}, f64 on the card {ll64!r} ({f64_s:.2f} s; launches "
          f"{dict(_build.LAUNCHES)}), rel err {rel:.3e} (tol {NLML_REL_TOL:g})")
    if not rel <= NLML_REL_TOL:
        fail(f"the lazy f32 NLML at N={N_LAZY} disagrees with f64: {rel}")
    del data64
    if args.profile:
        print_profile(torch, lambda: model.log_likelihood(data), f"lazy NLML N={N_LAZY}", card, 1)

    # the column launches of one lazy NLML, timed as one group
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram, radial_gram_cols

    x = data.features
    diag = torch.full((N_LAZY,), NOISE * NOISE + JITTER, dtype=torch.float32, device=x.device)
    starts = range(0, N_LAZY, COL_B)

    def group():
        for j0 in starts:
            radial_gram_cols(x, j0, COL_B, LENGTH_SCALE, SIGMA, PROFILE, diag)

    def plain_group():
        for j0 in starts:
            plain_radial_gram(x[j0:], x[j0:j0 + COL_B], LENGTH_SCALE, SIGMA, PROFILE, diag[j0:j0 + COL_B])

    out = {"launches": counts["radial_gram_cols"], "value_grad_launches": vg_counts["radial_gram_cols"],
           "group_ms": cuda_ms(torch, group, batch=2), "group_plain_ms": cuda_ms(torch, plain_group, reps=3, batch=1)}
    out["group_bound_ms"], out["group_bound_by"] = cols_group_bound(N_LAZY, COL_B)
    print(f"[{card}] gram column launches of one lazy NLML N={N_LAZY} ({len(starts)} launches, "
          f"({N_LAZY}, {COL_B}) down to ({COL_B}, {COL_B})): kernel {out['group_ms']:.4f} ms, plain "
          f"{out['group_plain_ms']:.4f} ms, bound {out['group_bound_ms']:.4f} ms by {out['group_bound_by']} "
          f"({out['group_bound_ms'] / out['group_ms']:.1%} of it)")
    return out


def cv_errors(torch, got: dict, ref: dict) -> dict:
    """Largest |f32 - f64| over the largest |f64| entry, for each output."""
    return {k: ((got[k].double() - ref[k]).abs().max() / ref[k].abs().max()).item() for k in ref}


def check_cv(torch, np, pt, _build, card: str, data_main) -> None:
    """Fast cross-validation at N_GRAD (the value+grad phase's seed 2 data):
    LOO marginals (the vectorized path), LOGO of N_GRAD / CV_GROUP uniform
    groups as joints (the batched path) and a ragged LOGO as marginals (one
    group at a time), f32 against the same calls in f64 on the card, with a
    TF32 control; then LOO timed at N."""
    from albatross_tpu_torch.indexing import LeaveOneOutGrouper

    x_np, y_np = bench_data(np, N_GRAD, SEED + 2)
    model = bench_model(pt)
    groupers = {
        "loo": LeaveOneOutGrouper(),
        "logo": lambda features: np.arange(features.shape[0]) // CV_GROUP,
        "ragged": lambda features: np.floor(features.cpu().numpy() / CV_RAGGED_WIDTH).astype(np.int64),
    }

    def run(data) -> dict:
        cv = model.cross_validate()
        loo = cv.predict(data, groupers["loo"]).marginals()
        logo = cv.predict(data, groupers["logo"]).joints()
        ragged = cv.predict(data, groupers["ragged"]).marginals()
        torch.cuda.synchronize()
        if loo.means.shape != (N_GRAD, 1) or logo.covariances.shape != (N_GRAD // CV_GROUP, CV_GROUP, CV_GROUP):
            fail(f"CV shapes: LOO {tuple(loo.means.shape)}, LOGO {tuple(logo.covariances.shape)}")
        return {"loo mean": loo.means, "loo variance": loo.variances, "logo mean": logo.means,
                "logo covariance": logo.covariances,
                "ragged mean": torch.cat([m.mean for m in ragged.values()]),
                "ragged variance": torch.cat([m.variance for m in ragged.values()])}

    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    _build.reset_launch_counts()
    got = run(data)
    counts = dict(_build.LAUNCHES)
    ref = run(pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64))
    n_ragged = len(pt.indexing.group_by(data, groupers["ragged"]).indexers())
    errors = cv_errors(torch, got, ref)
    print(f"CV N={N_GRAD} f32 vs f64 on the card (LOO; LOGO of {N_GRAD // CV_GROUP} groups of {CV_GROUP}; "
          f"ragged LOGO of {n_ragged} groups): " + ", ".join(f"{k} {v:.3e} (tol {CV_TOLS[k]:g})"
                                                             for k, v in errors.items()))
    print(f"CV launches (three fits): {counts}")
    if not all(math.isfinite(v) for v in errors.values()):
        fail(f"CV results are not finite: {errors}")
    if counts["radial_gram_diag"] != 3 or counts["panel_cholinv"] != 3 * PANELS_GRAD:
        fail(f"CV launch counts {counts}")
    if not all(errors[k] <= CV_TOLS[k] for k in errors):
        fail(f"CV disagrees with f64: {errors}")
    torch.set_float32_matmul_precision("high")
    tf32 = cv_errors(torch, run(data), ref)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    print("CV TF32 control: " + ", ".join(f"{k} {v:.3e}" for k, v in tf32.items()))
    failed = [k for k in tf32 if not tf32[k] <= CV_TOLS[k]]
    if not failed:
        fail(f"the CV gates accept a TF32 factorization: {tf32}")
    print(f"CV TF32 control: rejected by the gates of {failed}")
    del got, ref

    times = []
    for _ in range(CV_REPS):
        t = time.perf_counter()
        loo = model.cross_validate().predict(data_main, groupers["loo"]).marginals()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if loo.means.shape != (N, 1) or not (torch.isfinite(loo.means).all() and (loo.variances > 0).all()):
        fail(f"LOO at N={N}: shape {tuple(loo.means.shape)}, finite {torch.isfinite(loo.means).all().item()}")
    print(f"[{card}] fast LOO marginals N={N} f32 (fit, L^-1, grouping): {statistics.median(times):.4f} s "
          f"(median of {CV_REPS}; all {times})")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also print a torch.profiler breakdown of the NLML's device time")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to run", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "albatross_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the albatross_tpu_torch package is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))

    import numpy as np

    import albatross_tpu_torch as pt
    from albatross_tpu_torch import _build, config
    from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv, panel_cholinv_backward, plain_panel_cholinv
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram, radial_gram

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- build: one nvcc for each source, all started together --------------
    t0 = time.perf_counter()
    _build.load_all()
    for name in _build.KERNELS:
        seconds, log = _build.build_info(name)
        print(f"build {name}: {seconds:.1f} s; {ptxas_summary(log)}")
    print(f"kernel build total: {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    x_np = np.sort(rng.uniform(0.0, 100.0, N)).astype(np.float32)
    y_np = (np.sin(0.3 * x_np) + 0.1 * rng.standard_normal(N)).astype(np.float32)
    xs_np = np.linspace(0.0, 100.0, N_TEST).astype(np.float32)
    x = torch.as_tensor(x_np, device=dev)
    y = torch.as_tensor(y_np, device=dev)
    xs = torch.as_tensor(xs_np, device=dev)
    diag_value = NOISE * NOISE + JITTER
    diag = torch.full((N,), diag_value, dtype=torch.float32, device=dev)
    profile = PROFILE
    results = {}

    # -- kernels against their plain versions ----------------------------
    K = radial_gram(x, x, LENGTH_SCALE, SIGMA, profile, diag_add=diag)
    Kp = plain_radial_gram(x, x, LENGTH_SCALE, SIGMA, profile, diag)
    err = (K - Kp).abs().max().item()
    print(f"gram_diag N={N} D=1 f32: max|kernel - plain| = {err:.3e} (tol {GRAM_F32_TOL:g})")
    if not err <= GRAM_F32_TOL * SIGMA**2:
        fail(f"gram_diag disagrees with its plain version: {err}")
    if not torch.equal(K, K.T):
        fail("gram_diag output is not bitwise symmetric")
    s32 = torch.tensor(SIGMA, dtype=torch.float32, device=dev)
    if not torch.equal(K.diagonal(), s32 * s32 + diag):
        fail("gram_diag diagonal is not exactly sigma^2 + diag")
    print("gram_diag: bitwise symmetric, diagonal exactly sigma^2 + diag")
    results["radial_gram_diag"] = {"max_abs_err": err}
    del K, Kp

    C = radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile)
    err = (C - plain_radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile)).abs().max().item()
    print(f"cross gram ({N}, {N_TEST}) D=1 f32: max|kernel - plain| = {err:.3e}")
    if not err <= GRAM_F32_TOL * SIGMA**2:
        fail(f"cross gram disagrees with its plain version: {err}")
    results["radial_gram"] = {"max_abs_err": err}
    cols_err = check_column_blocks(torch, x, diag)

    g = torch.Generator(device="cpu").manual_seed(SEED)
    X16 = (10.0 * torch.rand((4096, 16), generator=g)).to(dev)
    Y16 = (10.0 * torch.rand((2048, 16), generator=g)).to(dev)
    K16 = radial_gram(X16, Y16, 3.0, 1.5, "matern_52")
    ref16 = plain_radial_gram(X16.double(), Y16.double(), 3.0, 1.5, "matern_52")
    err = (K16.double() - ref16).abs().max().item()
    err_plain = (plain_radial_gram(X16, Y16, 3.0, 1.5, "matern_52").double() - ref16).abs().max().item()
    print(f"gram D=16 matern_52 f32: max|kernel - f64| = {err:.3e}, max|plain f32 - f64| = {err_plain:.3e}")
    if not err <= GRAM_F32_TOL * 1.5**2:
        fail(f"D=16 gram disagrees with the f64 closed form: {err}")

    X64 = (100.0 * torch.rand((4096, 3), generator=g, dtype=torch.float64)).to(dev)
    d64 = torch.full((4096,), 0.01, dtype=torch.float64, device=dev)
    K64 = radial_gram(X64, X64, 7.0, 2.0, "matern_32", diag_add=d64)
    err = (K64 - plain_radial_gram(X64, X64, 7.0, 2.0, "matern_32", d64)).abs().max().item()
    print(f"gram_diag D=3 matern_32 f64: max|kernel - plain| = {err:.3e} (tol {GRAM_F64_TOL:g})")
    if not err <= GRAM_F64_TOL * 4.0:
        fail(f"f64 gram disagrees with its plain version: {err}")
    if not torch.equal(K64, K64.T):
        fail("f64 gram_diag output is not bitwise symmetric")
    del K16, ref16, K64

    panel_errs = []
    for b in (128, 256, 1024):
        M = torch.randn((b, b), generator=g, dtype=torch.float64)
        A64 = (M @ M.T + b * torch.eye(b, dtype=torch.float64)).to(dev)
        A = A64.float()
        U, Wu = panel_cholinv(A)
        L = torch.linalg.cholesky(A.double())
        W = torch.linalg.inv(L)
        eu = ((U.T.double() - L).abs().max() / L.abs().max()).item()
        ew = ((Wu.T.double() - W).abs().max() / W.abs().max()).item()
        lower_zero = bool((torch.tril(U, -1) == 0).all() and (torch.tril(Wu, -1) == 0).all())
        print(f"panel b={b}: rel err U {eu:.3e} (tol {PANEL_U_TOL:g}), Wu {ew:.3e} (tol {PANEL_WU_TOL:g}), "
              f"strict lower exactly 0: {lower_zero}")
        if not (eu <= PANEL_U_TOL and ew <= PANEL_WU_TOL and lower_zero):
            fail(f"panel kernel at b={b}")
        panel_errs.append(max(eu, ew))
    A_bad = A.clone()
    A_bad[5, 5] = -1.0
    U_bad, _ = panel_cholinv(A_bad)
    if not torch.isnan(U_bad).any().item():
        fail("a non-SPD panel did not surface as NaN")
    print("panel: a non-SPD pivot surfaces as NaN")
    A128 = A[:128, :128].contiguous()  # one tile: the tile step alone
    errs = []
    for what, P in (("b=1024 M M^T + bI", A), ("b=128", A128)):
        Up, Wp = plain_panel_cholinv(P)
        U, Wu = panel_cholinv(P)
        err = max((U - Up).abs().max().item(), (Wu - Wp).abs().max().item())
        eu = ((U - Up).abs().max() / Up.abs().max()).item()
        ew = ((Wu - Wp).abs().max() / Wp.abs().max()).item()
        print(f"panel {what}: max|kernel - plain| = {err:.3e}; relative to the max entry "
              f"U {eu:.3e}, Wu {ew:.3e} (tol {PANEL_PLAIN_TOL:g})")
        if not (eu <= PANEL_PLAIN_TOL and ew <= PANEL_PLAIN_TOL):
            fail(f"panel kernel disagrees with its plain version at {what}")
        errs.append(err)
    results["panel_cholinv"] = {"max_abs_err": max(errs)}
    # The first diagonal panel of the main path: 1024 points about 0.0035
    # apart under a length scale of 0.5, so kappa ~ 1e4 and the f32 errors
    # of both versions grow with it; each is held against f64 at the JAX
    # package's bounds, side by side.
    A_path = radial_gram(x[:1024], x[:1024], LENGTH_SCALE, SIGMA, profile, diag_add=diag[:1024])
    L = torch.linalg.cholesky(A_path.double())
    W = torch.linalg.inv(L)
    line = []
    for what, (U, Wu) in (("kernel", panel_cholinv(A_path)), ("plain", plain_panel_cholinv(A_path))):
        eu = ((U.T.double() - L).abs().max() / L.abs().max()).item()
        ew = ((Wu.T.double() - W).abs().max() / W.abs().max()).item()
        line.append(f"{what} U {eu:.3e}, Wu {ew:.3e}")
        if what == "kernel" and not (eu <= PANEL_U_TOL and ew <= PANEL_WU_TOL):
            fail(f"panel kernel on the main path's first panel: U {eu}, Wu {ew}")
    print(f"panel b=1024 main path's first panel, rel err vs f64: {'; '.join(line)}")

    # -- the main path, through the public API -----------------------------
    model = bench_model(pt)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)  # the card by default
    if not data.features.is_cuda:
        fail(f"numpy data without a device landed on {data.features.device}, not the card")

    _build.reset_launch_counts()
    ll = model.log_likelihood(data)
    torch.cuda.synchronize()
    nlml_counts = dict(_build.LAUNCHES)
    fit = model.fit(data)
    pred = fit.predict(xs).marginal()
    torch.cuda.synchronize()
    path_counts = dict(_build.LAUNCHES)
    print(f"launches in log_likelihood: {nlml_counts}")
    print(f"launches in the whole main path (NLML + fit + predict): {path_counts}")
    if (nlml_counts["radial_gram_diag"] != 1 or nlml_counts["panel_cholinv"] != PANELS
            or nlml_counts["radial_gram_cols"] != 0):
        fail(f"log_likelihood launch counts {nlml_counts}")
    if (path_counts["radial_gram"] < 1 or path_counts["radial_gram_diag"] != 2
            or path_counts["panel_cholinv"] != 2 * PANELS):
        fail(f"main-path launch counts {path_counts}")

    # f64 plain reference on the card, same inputs
    x64, y64, xs64 = x.double(), y.double(), xs.double()
    K_ref = plain_radial_gram(x64, x64, LENGTH_SCALE, SIGMA, profile,
                              torch.full((N,), diag_value, dtype=torch.float64, device=dev))
    L_ref = torch.linalg.cholesky(K_ref)
    white = torch.linalg.solve_triangular(L_ref, y64[:, None], upper=False)[:, 0]
    ll_ref = -0.5 * (2.0 * torch.log(L_ref.diagonal()).sum() + white @ white + N * math.log(2 * math.pi))
    ll_ref_val = ll_ref.item()
    cross = plain_radial_gram(x64, xs64, LENGTH_SCALE, SIGMA, profile)
    mean_ref = cross.T @ torch.cholesky_solve(y64[:, None], L_ref)[:, 0]
    explained = torch.cholesky_solve(cross, L_ref)
    var_ref = SIGMA**2 - (explained * cross).sum(0)
    del K_ref, L_ref, cross, explained

    def gate_errors(ll, pred):
        """(NLML relative error, max |mean error|, max |variance error|)
        against the f64 reference; NaN when anything is non-finite."""
        if pred.mean.shape != (N_TEST,) or pred.variance.shape != (N_TEST,):
            fail(f"predict shapes {tuple(pred.mean.shape)}, {tuple(pred.variance.shape)}")
        rel = abs(ll.item() - ll_ref_val) / abs(ll_ref_val)
        mean_err = (pred.mean.double() - mean_ref).abs().max().item()
        var_err = (pred.variance.double() - var_ref).abs().max().item()
        return rel, mean_err, var_err

    def gates_pass(errors):
        rel, mean_err, var_err = errors  # NaN compares False: a NaN fails
        return rel <= NLML_REL_TOL and mean_err <= PREDICT_MEAN_TOL and var_err <= PREDICT_VAR_TOL

    errors = gate_errors(ll, pred)
    print(f"log_likelihood f32 = {ll.item()!r}, f64 plain = {ll_ref_val!r}, "
          f"rel err {errors[0]:.3e} (tol {NLML_REL_TOL:g})")
    print(f"predict marginal at {N_TEST} points: max|mean - f64| = {errors[1]:.3e} "
          f"(tol {PREDICT_MEAN_TOL:g}), max|variance - f64| = {errors[2]:.3e} (tol {PREDICT_VAR_TOL:g})")
    if not gates_pass(errors):
        fail(f"the main path disagrees with the f64 reference: {errors}")
    del fit, pred

    # TF32 control: the same path with TF32 GEMMs must fail the gates above.
    torch.set_float32_matmul_precision("high")
    try:
        tf32_errors = gate_errors(model.log_likelihood(data), model.fit(data).predict(xs).marginal())
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"TF32 control: NLML rel err {tf32_errors[0]:.3e}, max|mean - f64| = {tf32_errors[1]:.3e}, "
          f"max|variance - f64| = {tf32_errors[2]:.3e}")
    if gates_pass(tf32_errors):
        fail(f"the end-to-end gates accept a TF32 factorization: {tf32_errors}")
    print("TF32 control: the end-to-end gates reject it")
    check_f64_path(torch, np, pt, _build, model)
    grad_counts = check_value_grad(torch, np, pt, _build, config, card, args)

    # -- timings (after the counted run) -----------------------------------
    def nlml_once():
        model.log_likelihood(data)

    nlml_times = []
    nlml_once()
    torch.cuda.synchronize()
    for _ in range(REPS):
        t = time.perf_counter()
        nlml_once()
        torch.cuda.synchronize()
        nlml_times.append(time.perf_counter() - t)
    s_eval = statistics.median(nlml_times)
    fp_times = []
    for _ in range(3):
        t = time.perf_counter()
        model.fit(data).predict(xs).marginal()
        torch.cuda.synchronize()
        fp_times.append(time.perf_counter() - t)
    print(f"[{card}] NLML N={N} f32: {s_eval:.4f} s/eval (median of {REPS}; all {nlml_times}), "
          f"{nlml_flops(N) / s_eval / 1e12:.3f} TFLOP/s by bench.py's nlml_flops")
    print(f"[{card}] fit + predict marginal ({N} -> {N_TEST}): {statistics.median(fp_times):.4f} s "
          f"(median of 3; all {fp_times})")

    results["radial_gram_diag"]["ms"] = cuda_ms(torch, lambda: radial_gram(x, x, LENGTH_SCALE, SIGMA, profile, diag_add=diag))
    results["radial_gram_diag"]["plain_ms"] = cuda_ms(torch, lambda: plain_radial_gram(x, x, LENGTH_SCALE, SIGMA, profile, diag))
    results["radial_gram"]["ms"] = cuda_ms(torch, lambda: radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile))
    results["radial_gram"]["plain_ms"] = cuda_ms(torch, lambda: plain_radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile))
    results["panel_cholinv"]["ms"] = cuda_ms(torch, lambda: panel_cholinv(A))
    results["panel_cholinv"]["plain_ms"] = cuda_ms(torch, lambda: plain_panel_cholinv(A))
    for name, (ms, by) in (("radial_gram_diag", gram_bound(N, N, 1, 4, square=True, diag=True)),
                           ("radial_gram", gram_bound(N, N_TEST, 1, 4, square=False, diag=False)),
                           ("panel_cholinv", panel_bound(A.shape[0]))):
        results[name]["bound_ms"], results[name]["bound_by"] = ms, by
    for name, r in results.items():
        print(f"[{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} of it)")
    # the card's write floor: a write-only fill of a buffer of each gram's shape
    for name, cols in (("radial_gram_diag", N), ("radial_gram", N_TEST)):
        r = results[name]
        buf = torch.empty((N, cols), dtype=torch.float32, device=dev)
        r["write_floor_ms"] = cuda_ms(torch, lambda: buf.fill_(0.5))
        del buf
        written = 4 * N * cols
        print(f"[{card}] {name} ({N}, {cols}) f32: {written / r['ms'] / 1e9:.3f} TB/s written, "
              f"{r['bound_ms'] / r['ms']:.1%} of the {HBM_BYTES_PER_S / 1e12:.2f} TB/s bound; write floor "
              f"(fill_) {r['write_floor_ms']:.4f} ms = {written / r['write_floor_ms'] / 1e9:.3f} TB/s")
    X16 = (10.0 * torch.rand((N, 16), generator=g)).to(dev)
    Y16 = (10.0 * torch.rand((N_TEST, 16), generator=g)).to(dev)
    ms16 = cuda_ms(torch, lambda: radial_gram(X16, Y16, 3.0, 1.5, "matern_52"))
    bound16, by16 = gram_bound(N, N_TEST, 16, 4, square=False, diag=False)
    print(f"[{card}] radial_gram ({N}, {N_TEST}) D=16 matern_52 f32: kernel {ms16:.4f} ms, "
          f"bound {bound16:.4f} ms by {by16} ({bound16 / ms16:.1%} of it)")
    print(f"[{card}] panel_cholinv b=128 (one tile step): kernel "
          f"{cuda_ms(torch, lambda: panel_cholinv(A128)):.4f} ms, plain "
          f"{cuda_ms(torch, lambda: plain_panel_cholinv(A128)):.4f} ms")
    del X16, Y16
    # the panel's backward (five b x b FP32 products through torch.matmul)
    U, Wu = panel_cholinv(A)
    gU, gW = torch.randn_like(U), torch.randn_like(Wu)
    b = A.shape[0]
    back_bound, back_by = bound(4 * 5 * b * b, 10 * b**3)
    back_ms = cuda_ms(torch, lambda: panel_cholinv_backward(U, Wu, gU, gW))
    print(f"[{card}] panel_cholinv backward b={b}: {back_ms:.4f} ms, bound {back_bound:.4f} ms by {back_by} "
          f"({back_bound / back_ms:.1%} of it)")
    time_value_grad_big(torch, model, data, card, args)
    if args.profile:
        print_profile(torch, lambda: model.log_likelihood(data), f"NLML N={N}", card, 2)
    check_lazy_at_main_n(torch, pt, _build, config, model, data, card, ll.item())
    check_cv(torch, np, pt, _build, card, data)
    lazy = check_lazy_big(torch, np, pt, _build, config, card, args)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a radial gram or a panel factor + inverse
            "value_grad_launches": grad_counts["launches"][name],
        }
        if name in grad_counts["backwards"]:
            entry["value_grad_backward_calls"] = grad_counts["backwards"][name]
        if "write_floor_ms" in r:
            entry["write_floor_ms"] = r["write_floor_ms"]
        if name == "radial_gram_diag":  # the lazy loop's column launches of the same kernel
            entry.update({
                "lazy_launches": lazy["launches"], "lazy_value_grad_launches": lazy["value_grad_launches"],
                "lazy_group_ms": lazy["group_ms"], "lazy_group_plain_ms": lazy["group_plain_ms"],
                "lazy_group_bound_ms": lazy["group_bound_ms"], "lazy_group_bound_by": lazy["group_bound_by"],
                "lazy_max_abs_err": cols_err,
            })
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
