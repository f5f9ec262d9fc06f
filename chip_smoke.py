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
on the card, with a TF32 control, and times LOO at N = 28672.  The
serving-side and sparse phases follow, each held against the same calls
in f64 on the card with a TF32 control and its launch counts: FITC at
N = 131072 with 4096 inducing points (fit, predict, log_likelihood,
value+grad; the K_fu gram timed against its bound; |diag R| of the tall
QR by cuSOLVER's f32 and by the route's f64 against f64; the host's
grouping pass that FITC skips, timed), PITC at N = 32768 in
about 400 ragged groups and its update, the exact GP's update at the
main path's N against a refit, ``for_serving`` (bench.py's serving row:
chained predict batches against the factor, the Newton-Schulz residuals
and what raises them,
the construction at N = 28672), ``safe_factorization`` on a singular gram,
a ``fit_from_prediction`` round trip, the reference's temperature model
at N = 8192 stations (log_likelihood, fit -> predict on a sea-level grid,
fast LOO, RANSAC over 1% injected outliers; angular and radial metrics
over 4-column station rows) and a mixed-feature model over a TaggedBatch
of 8128 positions and 64 bias ids (fit, log_likelihood, predictions at
positions and at differences of positions), each held against f64 on the
card with a TF32 control and its launches counted.  The sampler phase
holds the two walker-batched kernel forms (a (16, 8192, 8192) stack of
training covariances from one gram launch, 16 panels of 1024 from one
panel call) against their plain versions and, slice by slice, against
the unbatched kernels, then runs the ensemble sampler through
``ensemble_sampler_from_model`` at N = 8192 with 32 walkers (its batched
f32 log-probs against the per-walker f64 log_likelihood on the card, with
a TF32 control, and against the per-walker f32 route; walker-steps/s,
peak memory, launch counts), bench.py's sampler row (N = 1024, 32
walkers, 64 iterations) and 32 walkers' batched log-probs at N = 28672,
more than the card holds as one stack, which run in batches that fit.  Any failed check raises.  Each kernel's time is printed
beside its bound (the least time the card could take for the same work);
the gram kernels also beside the card's write floor, a ``fill_`` of a
buffer of the gram's shape.
``--profile`` adds a torch.profiler breakdown of one NLML's device time and
of one value+grad evaluation's, forward and backward apart, of one
lazy NLML at N = 57344, of one FITC fit, and of one sampler half-step's
batched evaluation.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is visible or the port's package is not beside this
script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
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
# the sparse GP phases: FITC over N_FITC bench points with M_FITC inducing
# points uniformly spaced 100 / 4095 ~ FITC_LS / 2 apart, so the f32
# inducing gram has kappa ~1e4, as the main path's first panel; PITC
# grouped by floor(x / PITC_WIDTH), about 400 ragged groups of ~82; its
# update fits the first 3/4 and updates with the rest
N_FITC, M_FITC, FITC_LS = 131072, 4096, 0.05
N_PITC, M_PITC, PITC_LS, PITC_WIDTH = 32768, 1024, 0.2, 0.25
SPARSE_REPS = 3
N_UPDATE_FIRST = 24576  # the exact update: fit on these, update with the rest of N
N_SERVE, SERVE_LS, SERVE_R = 8192, 2.0, 64  # bench.py's serving row; R chained batches of N_TEST
N_SAFE_DISTINCT = 4096  # the safe fit: each of these points twice, no noise term
FFP_SPACING = 0.25  # fit_from_prediction at N_TEST points LENGTH_SCALE / 2 apart
# the temperature model (albatross_tpu_torch/temperature.py) at N_TEMP
# synthesized stations, a TEMP_GRID x TEMP_GRID sea-level grid, 1% of the
# stations made outliers, RANSAC with the example's configuration and
# TEMP_ITERATIONS iterations; the mixed-feature model at N_POS positions +
# N_BIAS bias ids (8 panels of 1024), predicted at N_TEST positions and
# at N_PAIRS differences of positions
N_TEMP, TEMP_GRID, TEMP_OUTLIERS, TEMP_ITERATIONS = 8192, 64, 82, 64
N_POS, N_BIAS, N_PAIRS = 8128, 64, 2048
PHASE_REPS = 3
# the sampler phase: the batched kernel forms checked at W_KERNEL walkers,
# N_SAMPLER points and panels of B_SAMPLER; the chain at N_SAMPLER (bench
# data, seed SEED + 2, the fused route) with W_SAMPLER walkers, 16 a half;
# bench.py's row (bench.py:231-263) at N_SAMPLER_BENCH
N_SAMPLER, W_KERNEL, B_SAMPLER = 8192, 16, 1024
W_SAMPLER, SAMPLER_ITERATIONS = 32, 16
N_SAMPLER_BENCH, SAMPLER_BENCH_ITERATIONS = 1024, 64
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

# The new phases' gates, each error the largest |f32 - f64| over the
# largest |f64| entry (relative for a scalar), about 10x the first reading
# on H100 (PERF.md section 6), so a TF32 run fails one of each phase's
# gates.  The sparse phases' readings are those of the tall QR in f64
# (FITC mean 1.16e-6, variance 2.8e-5, NLML 4.7e-6, gradient 3.8e-6; PITC
# 1.7e-6, 3.3e-5, 1.3e-6): cuSOLVER's f32 QR put them at 3e-3 to 1.4e-2.
# The serving variance is the explicit inverse's: the prior minus an f32
# quadratic form whose rounding floor is 0.13 of the largest variance
# (5.3e-2 read).
FITC_TOLS = {"mean": 1.2e-5, "variance": 2.8e-4, "nlml": 4.7e-5, "value": 4.7e-5, "gradient": 3.8e-5}
PITC_TOLS = {"mean": 1.7e-5, "variance": 3.3e-4, "nlml": 1.3e-5}
SPARSE_UPDATE_TOLS = {"mean": 1.8e-5, "variance": 3.5e-4, "full fit mean": 2.9e-4, "full fit variance": 2.1e-4}
UPDATE_TOLS = {"mean": 9.3e-5, "variance": 1.3e-4, "refit mean": 1.1e-4, "refit variance": 1.4e-4}
SERVING_TOLS = {"mean": 5.3e-6, "variance": 0.53, "factor mean": 5.3e-6, "factor variance": 8.2e-4}
# for_serving() at N against the factor's predictions: the mean takes the
# same information vector (equal); the variance about 10x its reading (1.8e-2).
SERVING_N_TOLS = {"mean": 5.3e-6, "variance": 0.18}
SAFE_TOLS = {"nlml": 0.1, "mean": 0.6, "variance": 0.075}
FFP_TOLS = {"mean": 4.8e-3, "covariance": 4.2e-6, "f64 mean": 5.8e-5, "f64 covariance": 2.3e-5}
# The temperature and mixed-feature phases, f32 against the same calls in
# f64 on the card, about 10x the first reading on H100 (PERF.md sections
# 2 and 6): temperature NLML 3.7e-3, mean 5.8e-3, variance 4.8e-2, LOO
# 7.7e-3 / 7.0e-2, RANSAC metrics 1.7e-2; mixed NLML 6.7e-6, mean 1.3e-4,
# variance 5.7e-6, differences 7.5e-5 / 3.7e-6.  The temperature model's
# f32 error is set by its angular metric: acos near 1 resolves no angle
# below ~3.5e-4 rad in f32 (6.3e-4 rad read), against a nearest-neighbour
# angle of 1.0e-3 rad.  TF32 makes both phases' factorizations NaN.
TEMP_TOLS = {"nlml": 3.7e-2, "mean": 5.8e-2, "variance": 0.48, "loo mean": 7.7e-2, "loo variance": 0.70,
             "ransac metrics": 0.17}
MIXED_TOLS = {"nlml": 6.7e-5, "mean": 1.3e-3, "variance": 5.7e-5, "difference mean": 7.5e-4,
              "difference variance": 3.7e-5}
# The sampler at N_SAMPLER: the initial walkers' batched f32 log-probs, the
# largest error over the walkers over the largest |f64| log-prob (a
# walker's own relative error is unbounded where its log-likelihood nears
# 0), against the per-walker f64 log_likelihood on the card and against the
# per-walker f32 route (the same panels, unbatched GEMMs): about 10x the
# first reading on H100 (8.15e-7 and 1.77e-7), so the TF32 control (2.5e-5
# against both) fails them.
SAMPLER_TOLS = {"f64": 8.2e-6, "per-walker f32": 1.8e-6}
# W_SAMPLER walkers at the main path's N hold more than the card's memory
# as one stack (32 x 3.3 GB in f32), so the batched log-prob splits them
# into batches that fit; two walkers' f32 log-probs against their
# per-walker f32 route, gated at the N_SAMPLER gate scaled by N / N_SAMPLER
# (rounding grows with n) and rounded up: 1.8e-6 x 3.5 -> 1e-5.
SPLIT_TOL = {"per-walker f32": 1e-5}

SOURCES = {
    "radial_gram": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:81"),
    "radial_gram_diag": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "panel_cholinv": ("albatross_tpu_torch/csrc/panel_cholinv.cu", "albatross_tpu/ops/pallas_chol.py:121"),
    # the sampler's walker-batched forms: jax.vmap over the same kernels
    "radial_gram_diag_batched": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "panel_cholinv_batched": ("albatross_tpu_torch/csrc/panel_cholinv.cu", "albatross_tpu/ops/pallas_chol.py:121"),
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


def print_profile(torch, fn, what: str, card: str, evals: int) -> tuple[float, float]:
    """Where ``fn``'s device time goes: torch.profiler over ``evals`` calls
    of it, device kernels only, per call, plus the device idle share
    against host wall time.  Returns (wall ms, device ms) per call."""
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
    return wall_ms / evals, device_us / 1e3 / evals


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


def max_rel(got, ref) -> float:
    """Largest |got - ref| over the largest |ref| entry, in f64 on ref's
    device; NaN (which fails every gate) when anything is not finite."""
    ref = ref.double()
    return ((got.double().to(ref.device) - ref).abs().max() / ref.abs().max()).item()


def scalar_rel(got, ref) -> float:
    return abs(float(got) - float(ref)) / abs(float(ref))


def check_gates(what: str, errors: dict, tols: dict) -> None:
    print(f"{what}: " + ", ".join(f"{k} {v:.3e} (tol {tols[k]:g})" for k, v in errors.items()))
    bad = {k: v for k, v in errors.items() if not v <= tols[k]}
    if bad:
        fail(f"{what} disagrees: {bad}")


def check_tf32_control(torch, what: str, run, tols: dict) -> None:
    """``run()`` again with TF32 GEMMs: one of its errors must fail its
    gate."""
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = run()
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{what} TF32 control: " + ", ".join(f"{k} {v:.3e}" for k, v in tf32.items()))
    failed = [k for k in tols if not tf32[k] <= tols[k]]
    if not failed:
        fail(f"the {what} gates accept a TF32 run: {tf32}")
    print(f"{what} TF32 control: rejected by the gates of {failed}")


def wall_times(torch, fn, reps: int) -> list:
    """Synchronised host wall seconds of ``reps`` calls of ``fn``."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return times


def check_counts(what: str, counts: dict, expected: dict) -> None:
    print(f"{what} launches: {counts}")
    if any(counts[k] != v for k, v in expected.items()):
        fail(f"{what} launch counts {counts}, expected {expected}")


def sparse_model(pt, length_scale: float, inducing, grouper=None):
    """SquaredExponential(length_scale, 1.0) + measurement_only(
    IndependentNoise(0.3, assume_unique=True)) as a sparse GP (FITC unless
    ``grouper``).  The bench model's noise: bench_data's sorted f32 inputs
    repeat a few values (18 at N_PITC), and noise by value would make
    those PITC blocks singular."""
    kernel = pt.SquaredExponential(length_scale, SIGMA) + pt.measurement_only(
        pt.IndependentNoise(NOISE, assume_unique=True))
    return pt.sparse_gp_from_covariance(kernel, grouper=grouper, inducing_point_strategy=inducing)


def check_fitc(torch, np, pt, _build, card: str, args) -> dict:
    """FITC at N_FITC with M_FITC uniformly spaced inducing points: fit,
    predict marginal at N_TEST points, log_likelihood and value+grad with
    respect to the tunable vector (the nuggets included), each against the
    same calls in f64 on the card, with a TF32 control; launch counts,
    times and peak memory; the cross gram K_fu timed against its bound."""
    from albatross_tpu_torch.indexing.grouping import group_by
    from albatross_tpu_torch.models.sparse_gp import EveryPointGrouper, _tall_qr
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram, radial_gram

    x_np, y_np = bench_data(np, N_FITC, SEED + 4)
    model = sparse_model(pt, FITC_LS, pt.UniformlySpacedInducingPoints(M_FITC))
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    fit = model.fit(data)
    pred = fit.predict(xs).marginal()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    fp_peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dict(_build.LAUNCHES)
    check_counts(f"FITC fit + predict N={N_FITC} M={M_FITC}", counts,
                 {"radial_gram": 3, "radial_gram_diag": 0, "radial_gram_cols": 0, "panel_cholinv": 4})
    if fit.fit.numerical_rank != M_FITC:
        fail(f"FITC numerical rank {fit.fit.numerical_rank}, expected {M_FITC}")
    _build.reset_launch_counts()
    ll = model.log_likelihood(data).item()
    ll_counts = dict(_build.LAUNCHES)
    check_counts("FITC log_likelihood", ll_counts, {"radial_gram": 2, "panel_cholinv": 4})
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    value, grad = value_grad(torch, model, data)
    vg_peak = torch.cuda.max_memory_allocated() / 2**30
    vg_counts, vg_backwards = dict(_build.LAUNCHES), dict(_build.BACKWARDS)
    check_counts("FITC value+grad", vg_counts, {"radial_gram": 2, "panel_cholinv": 4})
    if vg_backwards["panel_cholinv"] != 4 or grad.shape != (5,):
        fail(f"FITC value+grad: panel backward calls {vg_backwards}, gradient shape {tuple(grad.shape)}")

    data64 = pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)
    ref = model.fit(data64).predict(xs.double()).marginal()
    ll64 = model.log_likelihood(data64).item()
    value64, grad64 = value_grad(torch, model, data64)
    value64 = value64.item()

    # why the tall QR runs in f64: |diag R| of B (N_FITC + M_FITC rows) by
    # cuSOLVER's f32 QR and by the route's f64 one, against the f64 data's
    def augmented(d):
        u = model.inducing_point_strategy(model.covariance_function, d.features)
        A_chol, K_uu_chol, K_fu, _ = model._compute_internal_components(u, d.features, d.targets)
        return model._augmented(A_chol, K_uu_chol, K_fu)

    with torch.no_grad():
        B = augmented(data)
        diag32 = torch.linalg.qr(B, mode="r").R.diagonal().abs()
        diag_route = _tall_qr(B, "r")[1].diagonal().abs()
        del B
        diag64 = torch.linalg.qr(augmented(data64), mode="r").R.diagonal().abs()
    print(f"FITC N={N_FITC}: |diag R| of B against f64: cuSOLVER's f32 QR {max_rel(diag32, diag64):.3e}, the "
          f"route's f64 QR of the f32 B {max_rel(diag_route, diag64):.3e}")
    del data64, diag32, diag_route, diag64

    def errors_of(pred, ll, value, grad):
        return {"mean": max_rel(pred.mean, ref.mean), "variance": max_rel(pred.variance, ref.variance),
                "nlml": scalar_rel(ll, ll64), "value": scalar_rel(value, value64), "gradient": max_rel(grad, grad64)}

    errors = errors_of(pred, ll, value.item(), grad)
    print(f"FITC N={N_FITC}: log_likelihood f32 {ll!r}, f64 {ll64!r}; gradient f32 {grad.tolist()}, "
          f"f64 {grad64.tolist()}")
    check_gates(f"FITC N={N_FITC} f32 vs f64 on the card", errors, FITC_TOLS)

    def tf32_run():
        v, g = value_grad(torch, model, data)
        return errors_of(model.fit(data).predict(xs).marginal(), model.log_likelihood(data).item(), v.item(), g)

    check_tf32_control(torch, "FITC", tf32_run, FITC_TOLS)
    del pred, ref

    fp_times = wall_times(torch, lambda: model.fit(data).predict(xs).marginal(), SPARSE_REPS)
    ll_times = wall_times(torch, lambda: model.log_likelihood(data), SPARSE_REPS)
    vg_times = wall_times(torch, lambda: value_grad(torch, model, data), SPARSE_REPS)
    print(f"[{card}] FITC N={N_FITC} M={M_FITC} f32: fit + predict marginal ({N_TEST} points) "
          f"{statistics.median(fp_times):.4f} s (median of {SPARSE_REPS}; all {fp_times}; the first, counted "
          f"call {first_s:.4f} s), peak device memory {fp_peak:.2f} GiB; log_likelihood "
          f"{statistics.median(ll_times):.4f} s/eval (all {ll_times}); value+grad "
          f"{statistics.median(vg_times):.4f} s/eval (all {vg_times}), peak device memory {vg_peak:.2f} GiB")
    if args.profile:
        print_profile(torch, lambda: model.fit(data), f"FITC fit N={N_FITC} M={M_FITC}", card, 1)

    # the host pass FITC's EveryPointGrouper route skips: the grouped route's
    # group_by over N_FITC singleton groups and their concatenation
    def grouping_pass():
        values = group_by(data.features, EveryPointGrouper()).indexers().values()
        return np.concatenate(values), all(len(idx) == 1 for idx in values)

    group_times = wall_times(torch, grouping_pass, SPARSE_REPS)
    print(f"[{card}] FITC N={N_FITC}: the grouping pass the EveryPointGrouper route skips (group_by over "
          f"{N_FITC} singleton groups, concatenated) {statistics.median(group_times):.4f} s on the host (all "
          f"{group_times}), against fit + predict {statistics.median(fp_times):.4f} s")

    # the cross gram K_fu at (N_FITC, M_FITC) against its plain version and its bound
    x, u = data.features, fit.fit.train_features
    err = (radial_gram(x, u, FITC_LS, SIGMA, PROFILE) - plain_radial_gram(x, u, FITC_LS, SIGMA, PROFILE)).abs().max()
    cross = {"max_abs_err": err.item(),
             "ms": cuda_ms(torch, lambda: radial_gram(x, u, FITC_LS, SIGMA, PROFILE)),
             "plain_ms": cuda_ms(torch, lambda: plain_radial_gram(x, u, FITC_LS, SIGMA, PROFILE), reps=3, batch=2)}
    cross["bound_ms"], cross["bound_by"] = gram_bound(N_FITC, M_FITC, 1, 4, square=False, diag=False)
    print(f"[{card}] radial_gram K_fu ({N_FITC}, {M_FITC}) D=1 f32: max|kernel - plain| = "
          f"{cross['max_abs_err']:.3e}; kernel {cross['ms']:.4f} ms, plain {cross['plain_ms']:.4f} ms, bound "
          f"{cross['bound_ms']:.4f} ms by {cross['bound_by']} ({cross['bound_ms'] / cross['ms']:.1%} of it)")
    if not cross["max_abs_err"] <= GRAM_F32_TOL * SIGMA**2:
        fail(f"K_fu gram disagrees with its plain version: {cross['max_abs_err']}")
    return {"launches": counts, "cross": cross}


def check_pitc(torch, np, pt, _build, card: str) -> dict:
    """PITC at N_PITC, M_PITC, groups by floor(x / PITC_WIDTH): fit,
    predict marginal and log_likelihood against f64 on the card with a TF32
    control, one gram launch a group, wall time against device time.  Then
    the sparse update: a fit on the first 3/4 updated with the rest, on a
    fixed inducing grid, held against f64 and against a fit of all the
    data.  Returns both runs' launch counts."""
    x_np, y_np = bench_data(np, N_PITC, SEED + 5)

    def grouper(features):
        return np.floor(features.cpu().numpy() / PITC_WIDTH).astype(np.int64)

    sizes = np.unique(grouper(torch.as_tensor(x_np)), return_counts=True)[1]
    n_groups = len(sizes)
    model = sparse_model(pt, PITC_LS, pt.UniformlySpacedInducingPoints(M_PITC), grouper)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    data64 = pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")

    _build.reset_launch_counts()
    fit = model.fit(data)
    pred = fit.predict(xs).marginal()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check_counts(f"PITC fit + predict N={N_PITC} M={M_PITC}, {n_groups} groups", counts,
                 {"radial_gram": n_groups + 3, "radial_gram_diag": 0, "radial_gram_cols": 0, "panel_cholinv": 0})
    ll = model.log_likelihood(data).item()
    ref = model.fit(data64).predict(xs.double()).marginal()
    ll64 = model.log_likelihood(data64).item()

    def errors_of(pred, ll):
        return {"mean": max_rel(pred.mean, ref.mean), "variance": max_rel(pred.variance, ref.variance),
                "nlml": scalar_rel(ll, ll64)}

    errors = errors_of(pred, ll)
    print(f"PITC N={N_PITC}: {n_groups} groups of {min(sizes)}-{max(sizes)} points; log_likelihood f32 {ll!r}, "
          f"f64 {ll64!r}")
    check_gates(f"PITC N={N_PITC} f32 vs f64 on the card", errors, PITC_TOLS)
    check_tf32_control(torch, "PITC", lambda: errors_of(model.fit(data).predict(xs).marginal(),
                                                      model.log_likelihood(data).item()), PITC_TOLS)
    fp_times = wall_times(torch, lambda: model.fit(data).predict(xs).marginal(), SPARSE_REPS)
    ll_times = wall_times(torch, lambda: model.log_likelihood(data), SPARSE_REPS)
    wall_ms, device_ms = print_profile(torch, lambda: model.fit(data), f"PITC fit N={N_PITC}", card, 1)
    print(f"[{card}] PITC N={N_PITC} M={M_PITC} f32, {n_groups} groups: fit + predict marginal "
          f"{statistics.median(fp_times):.4f} s (median of {SPARSE_REPS}; all {fp_times}); log_likelihood "
          f"{statistics.median(ll_times):.4f} s/eval (all {ll_times}); the fit under the profiler: wall "
          f"{wall_ms:.1f} ms, device {device_ms:.1f} ms")

    # the sparse update, on one inducing grid for every fit
    def grid(covariance, features):
        return torch.linspace(0.0, 100.0, M_PITC, dtype=features.dtype, device=features.device)

    fixed = sparse_model(pt, PITC_LS, grid, grouper)
    n1 = 3 * N_PITC // 4

    def update_run(dtype, count: bool = False):
        xd, yd = x_np.astype(dtype), y_np.astype(dtype)
        first = pt.RegressionDataset.create(xd[:n1], yd[:n1])
        rest = pt.RegressionDataset.create(xd[n1:], yd[n1:])
        fit1 = fixed.fit(first)
        if count:
            _build.reset_launch_counts()
        updated = fit1.update(rest)
        pred = updated.predict(xs.to(first.features.dtype)).marginal()
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        full = fixed.fit(pt.RegressionDataset.create(xd, yd)).predict(xs.to(first.features.dtype)).marginal()
        return pred, full, counts

    up, full, up_counts = update_run(np.float32, count=True)
    n_rest = len(np.unique(grouper(torch.as_tensor(x_np[n1:]))))
    check_counts(f"sparse update ({N_PITC - n1} points, {n_rest} groups) + predict", up_counts,
                 {"radial_gram": n_rest + 3, "radial_gram_diag": 0, "panel_cholinv": 0})
    up64, full64, _ = update_run(np.float64)

    def update_errors(up, full):
        return {"mean": max_rel(up.mean, up64.mean), "variance": max_rel(up.variance, up64.variance),
                "full fit mean": max_rel(up.mean, full.mean), "full fit variance": max_rel(up.variance, full.variance)}

    errors = update_errors(up, full)
    print(f"sparse update in f64: against the f64 fit of all the data, mean {max_rel(up64.mean, full64.mean):.3e}, "
          f"variance {max_rel(up64.variance, full64.variance):.3e} (the group split at point {n1})")
    check_gates(f"sparse update N={n1} + {N_PITC - n1} f32 vs f64 on the card and vs a full fit", errors,
                SPARSE_UPDATE_TOLS)
    check_tf32_control(torch, "sparse update", lambda: update_errors(*update_run(np.float32)[:2]),
                       SPARSE_UPDATE_TOLS)
    return {"launches": counts, "update_launches": up_counts}


def check_exact_update(torch, np, pt, _build, card: str, x_np, y_np, xs) -> dict:
    """The exact GP's update at the main path's N: SquaredExponential(0.5,
    1.0) + IndependentNoise(0.3) (no measurement-only term, so an update
    equals a refit), jitter 1e-4, fit on N_UPDATE_FIRST points and updated
    with the rest; its marginal predictions against a direct fit of all N
    in f32 and in f64 on the card, with a TF32 control; the update timed
    against the refit."""
    from albatross_tpu_torch.ops.block import BlockSymmetric

    kernel = pt.SquaredExponential(LENGTH_SCALE, SIGMA) + pt.IndependentNoise(NOISE, assume_unique=True)
    model = pt.gp_from_covariance(kernel, jitter=JITTER)

    def datasets(dtype):
        xd, yd = x_np.astype(dtype), y_np.astype(dtype)
        return (pt.RegressionDataset.create(xd[:N_UPDATE_FIRST], yd[:N_UPDATE_FIRST]),
                pt.RegressionDataset.create(xd[N_UPDATE_FIRST:], yd[N_UPDATE_FIRST:]),
                pt.RegressionDataset.create(xd, yd))

    first, rest, full = datasets(np.float32)
    fit1 = model.fit(first)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    updated = fit1.update(rest)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check_counts(f"exact update {N_UPDATE_FIRST} + {N - N_UPDATE_FIRST}", counts,
                 {"radial_gram": 3, "radial_gram_diag": 0, "panel_cholinv": (N - N_UPDATE_FIRST) // 1024})
    if not isinstance(updated.fit.train_covariance, BlockSymmetric) or updated.for_serving() is not updated:
        fail("the updated fit is not a BlockSymmetric fit that for_serving leaves as it is")
    pred = updated.predict(xs).marginal()
    refit = model.fit(full).predict(xs).marginal()
    first64, rest64, full64 = datasets(np.float64)
    ref = model.fit(full64).predict(xs.double()).marginal()
    up64 = model.fit(first64).update(rest64).predict(xs.double()).marginal()
    del first64, rest64, full64

    def errors_of(pred, refit):
        return {"mean": max_rel(pred.mean, ref.mean), "variance": max_rel(pred.variance, ref.variance),
                "refit mean": max_rel(pred.mean, refit.mean), "refit variance": max_rel(pred.variance, refit.variance)}

    errors = errors_of(pred, refit)
    print(f"exact update in f64 against the f64 refit: mean {max_rel(up64.mean, ref.mean):.3e}, variance "
          f"{max_rel(up64.variance, ref.variance):.3e}")
    check_gates(f"exact update N={N_UPDATE_FIRST} + {N - N_UPDATE_FIRST} f32 vs the f64 refit and the f32 refit",
                errors, UPDATE_TOLS)
    check_tf32_control(torch, "exact update", lambda: errors_of(
        model.fit(first).update(rest).predict(xs).marginal(), model.fit(full).predict(xs).marginal()),
        UPDATE_TOLS)
    up_times = wall_times(torch, lambda: fit1.update(rest), SPARSE_REPS)
    refit_times = wall_times(torch, lambda: model.fit(full), SPARSE_REPS)
    print(f"[{card}] exact update {N_UPDATE_FIRST} + {N - N_UPDATE_FIRST} f32: "
          f"{statistics.median(up_times):.4f} s (median of {SPARSE_REPS}; all {up_times}) against a refit of "
          f"{N}: {statistics.median(refit_times):.4f} s (all {refit_times})")
    return {"launches": counts}


def check_serving(torch, np, pt, _build, card: str, main_model, main_data, xs) -> dict:
    """bench.py's serving row: N_SERVE points, SquaredExponential(2.0,
    1.0) + measurement_only(IndependentNoise(0.3)), jitter 1e-4;
    ``for_serving()`` predictions against the factor's and f64, with a
    TF32 control; max|I - A X| after 0, 1 and 2 Newton-Schulz steps; the
    time a batch of N_TEST over SERVE_R chained batches, each consuming
    every output of the one before; then the construction at N, its time
    and peak memory."""
    from albatross_tpu_torch.models.base import FitModel
    from albatross_tpu_torch.ops.linalg import DirectInverse

    rng = np.random.default_rng(1)  # bench.py's serving row
    x_np = np.sort(rng.uniform(0.0, 100.0, N_SERVE)).astype(np.float32)
    y_np = np.sin(0.3 * x_np)
    xq_np = np.sort(rng.uniform(0.0, 100.0, N_TEST)).astype(np.float32)
    kernel = pt.SquaredExponential(SERVE_LS, SIGMA) + pt.measurement_only(
        pt.IndependentNoise(NOISE, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=JITTER)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xq = torch.as_tensor(xq_np, device="cuda")

    _build.reset_launch_counts()
    fit = model.fit(data)
    serving = fit.for_serving()
    pred = serving.predict(xq).marginal()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check_counts(f"serving fit + for_serving + predict N={N_SERVE}", counts,
                 {"radial_gram": 1, "radial_gram_diag": 1, "panel_cholinv": N_SERVE // 1024})
    if not isinstance(serving.fit.train_covariance, DirectInverse):
        fail(f"for_serving gave a {type(serving.fit.train_covariance).__name__}")
    factor = fit.predict(xq).marginal()
    ref = model.fit(pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64))).predict(
        xq.double()).marginal()

    def errors_of(pred, factor):
        return {"mean": max_rel(pred.mean, ref.mean), "variance": max_rel(pred.variance, ref.variance),
                "factor mean": max_rel(factor.mean, ref.mean), "factor variance": max_rel(factor.variance, ref.variance)}

    errors = errors_of(pred, factor)
    check_gates(f"serving N={N_SERVE} f32 (explicit inverse, and the factor) vs f64 on the card", errors,
                SERVING_TOLS)

    def tf32_run():
        f = model.fit(data)
        return errors_of(f.for_serving().predict(xq).marginal(), f.predict(xq).marginal())

    check_tf32_control(torch, "serving", tf32_run, SERVING_TOLS)

    # Why the steps raise max|I - A X| and yet cut the variance's error:
    # the residual after 0, 1, 2 steps measured in f32 and in f64 (A = L L^T
    # of the f32 factor); inverse()'s asymmetry before the steps; the f32
    # GEMM's error in A X0 against the residual it feeds; one f32 step
    # without the final symmetrization X <- (X + X^T) / 2; one step in f64
    # from the same X0; and the variance's f32 rounding floor
    # eps max(|k|^T |X| |k|) over the largest f64 variance.
    chol = fit.fit.train_covariance
    A = chol.L @ chol.L.T
    A64 = chol.L.double() @ chol.L.double().T
    cross = model._cross(fit.fit, xq)
    X0 = chol.inverse()
    asymmetry = ((X0 - X0.T).abs().max() / X0.abs().max()).item()

    def served_errors(X):
        inverse = DirectInverse(X)
        p = FitModel(model, dataclasses.replace(fit.fit, train_covariance=inverse)).predict(xq).marginal()
        return max_rel(p.mean, ref.mean), max_rel(p.variance, ref.variance)

    def residual(A, X):
        R = A @ X
        R.diagonal().sub_(1.0)
        return R.abs().max().item()

    residuals, residuals64, steps_errors = [], [], []
    for steps in (0, 1, 2):
        X = chol.to_direct_inverse(refine_steps=steps).inverse_matrix
        residuals.append(residual(A, X))
        residuals64.append(residual(A64, X.double()))
        steps_errors.append(served_errors(X))
    quadratic = torch.sum(cross.abs() * (X.abs() @ cross.abs()), dim=0)
    variance_floor = torch.finfo(torch.float32).eps * quadratic.max().item() / ref.variance.abs().max().item()
    del X, quadratic
    R0 = A @ X0
    gemm_error = (R0.double() - A64 @ X0.double()).abs().max().item()
    R0.neg_()
    R0.diagonal().add_(1.0)
    unsymmetrized = residual(A64, (X0 + X0 @ R0).double())
    X64 = X0.double()
    R64 = A64 @ X64
    R64.neg_()
    R64.diagonal().add_(1.0)
    X64 = X64 + X64 @ R64
    X64 = 0.5 * (X64 + X64.T)
    step64 = (residual(A64, X64), residual(A64, X64.float().double()), served_errors(X64.float()))
    print(f"serving N={N_SERVE}: max|I - A X| after 0, 1, 2 Newton-Schulz steps {residuals} in f32, "
          f"{residuals64} in f64; predictions vs f64 (mean, variance) after 0, 1, 2 steps {steps_errors}; "
          f"inverse() asymmetry max|X - X^T| / max|X| {asymmetry:.3e}; the f32 GEMM A X0 off by {gemm_error:.3e} "
          f"against the residual's {residuals64[0]:.3e}; one f32 step without the symmetrization: max|I - A X| "
          f"{unsymmetrized:.3e}; one f64 step: {step64[0]:.3e} ({step64[1]:.3e} stored in f32), predictions "
          f"(stored in f32) {step64[2]}; the variance's f32 rounding floor {variance_floor:.3e}")
    del A, A64, X0, R0, X64, R64

    def chain(f):
        prev = torch.zeros((), device="cuda")
        for _ in range(SERVE_R):
            p = f.predict(xq + 1e-30 * prev).marginal()
            prev = p.mean[0] + 1e-30 * (p.mean.sum() + p.variance.sum())
        return prev

    chain(serving)
    chain(fit)
    serve_times, factor_times = [], []
    for _ in range(SPARSE_REPS):  # in turns
        serve_times += wall_times(torch, lambda: chain(serving), 1)
        factor_times += wall_times(torch, lambda: chain(fit), 1)
    serve_ms = statistics.median(serve_times) / SERVE_R * 1e3
    factor_ms = statistics.median(factor_times) / SERVE_R * 1e3
    print(f"[{card}] serving predict marginal N={N_SERVE} -> {N_TEST} f32, {SERVE_R} chained batches: explicit "
          f"inverse {serve_ms:.4f} ms/batch, factor {factor_ms:.4f} ms/batch (median of {SPARSE_REPS} chains; "
          f"all {serve_times} and {factor_times} s)")
    del fit, serving

    main_fit = main_model.fit(main_data)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    big = main_fit.for_serving()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30
    a, b = big.predict(xs).marginal(), main_fit.predict(xs).marginal()
    diffs = (max_rel(a.mean, b.mean), max_rel(a.variance, b.variance))
    print(f"[{card}] for_serving() at N={N} f32: {build_s:.4f} s, peak device memory {peak:.2f} GiB ({held:.2f} "
          f"GiB held before it); its predictions at {N_TEST} points against the factor's: mean {diffs[0]:.3e}, "
          f"variance {diffs[1]:.3e}")
    if not (diffs[0] <= SERVING_N_TOLS["mean"] and diffs[1] <= SERVING_N_TOLS["variance"]):
        fail(f"for_serving at N={N} changes the predictions: {diffs}")
    return {"launches": counts}


def check_safe(torch, np, pt, _build, card: str, xs) -> dict:
    """safe_factorization on a singular gram: N_SAFE_DISTINCT points, each
    twice, SquaredExponential(0.5, 1.0) with no noise term.  The f32 fit,
    predictions and log_likelihood are finite; the jitter the escalation
    chose is printed; the f32 results are held against an f64 fit at that
    jitter on the card, and a control at 100x that jitter must fail."""
    from albatross_tpu_torch.ops.linalg import CholeskyFactor
    from albatross_tpu_torch.ops.radial_gram import radial_gram

    x_np, y_np = bench_data(np, N_SAFE_DISTINCT, SEED + 6)
    x_np, y_np = np.repeat(x_np, 2), np.repeat(y_np, 2)
    model = pt.gp_from_covariance(pt.SquaredExponential(LENGTH_SCALE, SIGMA), safe_factorization=True)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    data64 = pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)

    _build.reset_launch_counts()
    pred = model.fit(data).predict(xs).marginal()
    ll = model.log_likelihood(data).item()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    check_counts(f"safe fit + predict + log_likelihood N={2 * N_SAFE_DISTINCT}", counts,
                 {"radial_gram": 1, "radial_gram_diag": 2, "panel_cholinv": 0})
    if not (math.isfinite(ll) and torch.isfinite(pred.mean).all() and torch.isfinite(pred.variance).all()):
        fail(f"the safe f32 fit is not finite: log_likelihood {ll}")
    zeros = torch.zeros(2 * N_SAFE_DISTINCT, device="cuda")
    jitter = CholeskyFactor.safe_jitter(radial_gram(data.features, data.features, LENGTH_SCALE, SIGMA, PROFILE,
                                                    diag_add=zeros))
    jitter64 = CholeskyFactor.safe_jitter(radial_gram(data64.features, data64.features, LENGTH_SCALE, SIGMA,
                                                      PROFILE, diag_add=zeros.double()))
    t = time.perf_counter()
    model.fit(data)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t

    def reference(j):
        ref_model = pt.gp_from_covariance(pt.SquaredExponential(LENGTH_SCALE, SIGMA), jitter=j)
        return ref_model.log_likelihood(data64).item(), ref_model.fit(data64).predict(xs.double()).marginal()

    def errors_of(pred, ll, ref):
        ll_ref, p_ref = ref
        return {"nlml": scalar_rel(ll, ll_ref), "mean": max_rel(pred.mean, p_ref.mean),
                "variance": max_rel(pred.variance, p_ref.variance)}

    ref = reference(jitter)
    errors = errors_of(pred, ll, ref)
    print(f"[{card}] safe fit N={2 * N_SAFE_DISTINCT} ({N_SAFE_DISTINCT} points twice, no noise) f32: jitter "
          f"chosen {jitter!r} (f64 would choose {jitter64!r}); log_likelihood {ll!r}; fit {fit_s:.4f} s")
    check_gates(f"safe fit f32 vs an f64 fit at jitter {jitter:g}", errors, SAFE_TOLS)
    control = errors_of(pred, ll, reference(100.0 * jitter))
    print("safe fit jitter control (against an f64 fit at 100x the jitter): "
          + ", ".join(f"{k} {v:.3e}" for k, v in control.items()))
    if all(control[k] <= SAFE_TOLS[k] for k in SAFE_TOLS):
        fail(f"the safe-fit gates accept a fit at 100x the chosen jitter: {control}")
    check_tf32_control(torch, "safe fit", lambda: errors_of(model.fit(data).predict(xs).marginal(),
                                                          model.log_likelihood(data).item(), ref), SAFE_TOLS)
    return {"launches": counts, "jitter": jitter}


def check_fit_from_prediction(torch, np, pt, _build, card: str, model, data, x_np, y_np) -> dict:
    """fit_from_prediction round trip: the main fit's joint prediction at
    N_TEST points FFP_SPACING apart (the prior gram's kappa ~1e4, which an
    f32 factorization without jitter takes), rebuilt as a fit, predicted
    again there and held against the first prediction and against the
    same round trip in f64 on the card, with a TF32 control."""
    from albatross_tpu_torch.ops.linalg import ExplainedCovariance

    grid = 50.0 + FFP_SPACING * (np.arange(N_TEST) - (N_TEST - 1) / 2.0)

    def round_trip(dtype, count: bool = False):
        d = data if dtype == np.float32 else pt.RegressionDataset.create(x_np.astype(dtype), y_np.astype(dtype))
        xg = torch.as_tensor(grid.astype(dtype), device="cuda")
        fit = model.fit(d)
        if count:
            _build.reset_launch_counts()
        joint = fit.predict(xg).joint()
        rebuilt = model.fit_from_prediction(xg, joint)
        again = rebuilt.predict(xg).joint()
        torch.cuda.synchronize()
        if not isinstance(rebuilt.fit.train_covariance, ExplainedCovariance):
            fail(f"fit_from_prediction gave a {type(rebuilt.fit.train_covariance).__name__}")
        return joint, again, dict(_build.LAUNCHES)

    joint, again, counts = round_trip(np.float32, count=True)
    check_counts(f"joint predict + fit_from_prediction + joint predict at {N_TEST} points", counts,
                 {"radial_gram": 5, "radial_gram_diag": 0, "panel_cholinv": 2 * N_TEST // 1024})
    joint64, again64, _ = round_trip(np.float64)

    def errors_of(joint, again):
        return {"mean": max_rel(again.mean, joint.mean), "covariance": max_rel(again.covariance, joint.covariance),
                "f64 mean": max_rel(again.mean, again64.mean),
                "f64 covariance": max_rel(again.covariance, again64.covariance)}

    errors = errors_of(joint, again)
    print(f"fit_from_prediction round trip in f64: mean {max_rel(again64.mean, joint64.mean):.3e}, covariance "
          f"{max_rel(again64.covariance, joint64.covariance):.3e}")
    check_gates(f"fit_from_prediction round trip at {N_TEST} points f32 (vs the first prediction; vs f64)",
                errors, FFP_TOLS)
    check_tf32_control(torch, "fit_from_prediction", lambda: errors_of(*round_trip(np.float32)[:2]), FFP_TOLS)
    return {"launches": counts}


def check_temperature(torch, np, pt, _build, card: str) -> dict:
    """The reference's temperature model (albatross_tpu_torch/temperature.py)
    at N_TEMP synthesized stations, f32 on the card, against the same calls
    in f64 on the card, with a TF32 control: log_likelihood; fit ->
    marginal prediction on a TEMP_GRID^2 sea-level grid; fast LOO
    marginals; RANSAC with the example's configuration over data with
    TEMP_OUTLIERS injected outliers, compared by its audit trail (the
    inlier metric of every group under every candidate: the same numpy
    draws in both dtypes) and its consensus.  Each step's launches are
    counted: the angular and radial metrics are not Euclidean, so the grams
    are torch ops and only the panel kernel runs (8 panels a fit; RANSAC's
    candidate fits are one batched library Cholesky, so its panels are the
    refit's).  Times are medians of PHASE_REPS."""
    from albatross_tpu_torch import temperature as tt
    from albatross_tpu_torch.indexing import LeaveOneOutGrouper, indices_from_groups
    from albatross_tpu_torch.kernels import AngularDistance
    from albatross_tpu_torch.ops.blocked_cholesky import cuda_block_size

    ransac_mod = importlib.import_module("albatross_tpu_torch.models.ransac")
    rng = np.random.default_rng(SEED + 7)
    stations, obs, _ = tt.synthesize_stations(N_TEMP, rng)
    bad, bad_idx = tt.inject_outliers(obs, TEMP_OUTLIERS, rng)
    bad_set = set(int(i) for i in bad_idx)
    repeats = N_TEMP - len(np.unique(stations.astype(np.float32), axis=0))
    model = tt.build_model()
    config = tt.ransac_config(N_TEMP, TEMP_ITERATIONS)
    strategy = pt.models.DefaultGPRansacStrategy()
    grid_np = tt.sea_level_grid(TEMP_GRID, TEMP_GRID)

    def datasets(dtype):
        ones = np.ones(N_TEMP, dtype)
        return (pt.RegressionDataset.create(stations.astype(dtype), obs.astype(dtype), variance=ones),
                pt.RegressionDataset.create(stations.astype(dtype), bad.astype(dtype), variance=ones),
                torch.as_tensor(grid_np.astype(dtype), device="cuda"))

    def run(dtype) -> dict:
        data, contaminated, grid = datasets(dtype)
        out = {"launches": {}}

        def step(name, fn):
            _build.reset_launch_counts()
            result = fn()
            torch.cuda.synchronize()
            out["launches"][name] = dict(_build.LAUNCHES)
            return result

        out["nlml"] = step("log_likelihood", lambda: model.log_likelihood(data).item())
        out["pred"] = step("fit + predict", lambda: model.fit(data).predict(grid).marginal())
        out["loo"] = step("LOO", lambda: model.cross_validate().predict(data, LeaveOneOutGrouper()).marginal())
        out["ransac"] = step("RANSAC", lambda: model.ransac(strategy, config).fit(contaminated).fit)
        return out

    got = run(np.float32)
    ref = run(np.float64)
    out32, out64 = got["ransac"].ransac_output, ref["ransac"].ransac_output

    def audit_values(output):
        return [{**it.inliers, **it.outliers} for it in output.iterations]

    def errors_of(run_):
        a32, a64 = audit_values(run_["ransac"].ransac_output), audit_values(out64)
        if [sorted(a) for a in a32] != [sorted(a) for a in a64]:
            fail("the f32 and f64 RANSAC runs drew different candidates")
        m32 = torch.tensor([[a[k] for k in sorted(a)] for a in a32], dtype=torch.float64)
        m64 = torch.tensor([[a[k] for k in sorted(a)] for a in a64], dtype=torch.float64)
        return {"nlml": scalar_rel(run_["nlml"], ref["nlml"]), "mean": max_rel(run_["pred"].mean, ref["pred"].mean),
                "variance": max_rel(run_["pred"].variance, ref["pred"].variance),
                "loo mean": max_rel(run_["loo"].mean, ref["loo"].mean),
                "loo variance": max_rel(run_["loo"].variance, ref["loo"].variance),
                "ransac metrics": max_rel(m32, m64)}

    errors = errors_of(got)
    rejected32 = set(range(N_TEMP)) - set(out32.best.consensus())
    rejected64 = set(range(N_TEMP)) - set(out64.best.consensus())
    print(f"temperature N={N_TEMP}: {repeats} repeated f32 station rows; log_likelihood f32 {got['nlml']!r}, "
          f"f64 {ref['nlml']!r}; RANSAC f32 {out32.return_code.name}, {len(out32.iterations)} iterations, "
          f"rejected {len(rejected32)} ({len(rejected32 & bad_set)} of the {TEMP_OUTLIERS} injected), f64 "
          f"{out64.return_code.name}, rejected {len(rejected64)} ({len(rejected64 & bad_set)} injected); "
          f"consensus symmetric difference {len(rejected32 ^ rejected64)}")
    for name, counts in got["launches"].items():
        print(f"temperature {name} launches: {counts}")
    # the angular metric's f32 floor: the diagonal of K(X, X), zero in exact
    # arithmetic, and the distances' error against f64
    X32 = torch.as_tensor(stations[:, :3].astype(np.float32), device="cuda")
    D32 = AngularDistance().pairwise(X32, X32)
    D64 = AngularDistance().pairwise(X32.double(), X32.double())
    print(f"temperature angular distance f32: diagonal max {D32.diagonal().max().item():.3e} rad "
          f"({int((D32.diagonal() > 0).sum())} of {N_TEMP} nonzero; f64 max {D64.diagonal().max().item():.3e}); "
          f"max|f32 - f64| over K(X, X) {(D32.double() - D64).abs().max().item():.3e} rad; nearest-neighbour "
          f"angle median {D64.fill_diagonal_(math.inf).min(dim=1).values.median().item():.3e} rad")
    del X32, D32, D64
    check_gates(f"temperature N={N_TEMP} f32 vs f64 on the card", errors, TEMP_TOLS)
    if not (pt.models.ransac_success(out32.return_code) and pt.models.ransac_success(out64.return_code)):
        fail(f"temperature RANSAC: f32 {out32.return_code.name}, f64 {out64.return_code.name}")
    n_good = N_TEMP - len(rejected32)
    b = cuda_block_size(n_good)
    expected = {"log_likelihood": 8, "fit + predict": 8, "LOO": 8, "RANSAC": -(-n_good // b)}
    for name, panels in expected.items():
        check_counts(f"temperature {name}", got["launches"][name],
                     {"radial_gram": 0, "radial_gram_diag": 0, "radial_gram_cols": 0, "panel_cholinv": panels})
    check_tf32_control(torch, "temperature", lambda: errors_of(run(np.float32)), TEMP_TOLS)

    data, contaminated, grid = datasets(np.float32)
    indexer = strategy.get_indexer(contaminated)
    good = indices_from_groups(indexer, out32.best.consensus())
    conditional = pt.ConditionalGaussian(model.prior(contaminated.features), contaminated.targets)
    candidates = np.stack([np.sort(rng.choice(N_TEMP, config.random_sample_size, replace=False))
                           for _ in range(TEMP_ITERATIONS)])
    groups = np.arange(N_TEMP)[:, None]
    times = {
        "log_likelihood": wall_times(torch, lambda: model.log_likelihood(data), PHASE_REPS),
        "fit + predict": wall_times(torch, lambda: model.fit(data).predict(grid).marginal(), PHASE_REPS),
        "LOO": wall_times(torch, lambda: model.cross_validate().predict(data, LeaveOneOutGrouper()).marginal(),
                          PHASE_REPS),
        "RANSAC prior": wall_times(torch, lambda: model.prior(contaminated.features), PHASE_REPS),
        f"RANSAC batched scores ({TEMP_ITERATIONS} x {N_TEMP}, read back)": wall_times(
            torch, lambda: ransac_mod.batched_inlier_metrics(conditional, candidates, groups).cpu(), PHASE_REPS),
        "RANSAC loop (prior, scores, host replay)": wall_times(
            torch, lambda: ransac_mod.ransac_gp_batched(strategy, model, contaminated, config), PHASE_REPS),
        "RANSAC refit": wall_times(torch, lambda: model.fit(contaminated.subset(good)), PHASE_REPS),
    }
    print(f"[{card}] temperature N={N_TEMP} f32 (median of {PHASE_REPS}, s): "
          + "; ".join(f"{k} {statistics.median(v):.4f} (all {v})" for k, v in times.items()))
    total = {k: sum(c[k] for c in got["launches"].values()) for k in got["launches"]["log_likelihood"]}
    return {"launches": total}


def check_mixed(torch, np, pt, _build, card: str) -> dict:
    """The mixed-feature model (tests/test_variants.py's kernel plus
    measurement noise) over a TaggedBatch of N_POS sorted positions and
    N_BIAS bias ids interleaved by a seeded permutation, target variance
    0.01, f32 on the card against the same calls in f64 on the card, with a
    TF32 control: fit, log_likelihood, marginal predictions at N_TEST plain
    positions and at N_PAIRS differences of positions.  The Euclidean
    positions' block, the cross gram and the differences' flattened gram
    launch the gram kernel; each fit factors 8 panels."""
    from albatross_tpu_torch.kernels import TaggedBatch, difference_of, for_tag

    POS, BIAS = 0, 1
    rng = np.random.default_rng(SEED + 8)
    positions = np.sort(rng.uniform(0.0, 100.0, N_POS))
    ids = np.arange(N_BIAS, dtype=np.float64)
    tags = rng.permutation(np.repeat([POS, BIAS], [N_POS, N_BIAS]))
    bias_values = rng.normal(0.0, 0.7, N_BIAS)
    y = np.empty(N_POS + N_BIAS)
    y[tags == POS] = np.sin(0.3 * positions)
    y[tags == BIAS] = bias_values
    y += 0.1 * rng.standard_normal(y.shape[0])
    a, b = rng.uniform(0.0, 100.0, N_PAIRS), rng.uniform(0.0, 100.0, N_PAIRS)
    kernel = (for_tag(pt.SquaredExponential(2.0, 1.5), POS) + for_tag(pt.IndependentNoise(0.7), BIAS)
              + pt.Constant(0.3) + pt.measurement_only(pt.IndependentNoise(0.1)))
    model = pt.gp_from_covariance(kernel)

    def inputs(dtype):
        t = {k: torch.as_tensor(v.astype(dtype), device="cuda") for k, v in
             (("pos", positions), ("ids", ids), ("y", y), ("a", a), ("b", b))}
        batch = TaggedBatch.create(tags, {POS: t["pos"], BIAS: t["ids"]})
        data = pt.RegressionDataset.create(batch, t["y"], variance=torch.full_like(t["y"], 0.01))
        return data, torch.linspace(0.0, 100.0, N_TEST, dtype=t["y"].dtype, device="cuda"), difference_of(t["a"], t["b"])

    def run(dtype) -> dict:
        data, xs, diffs = inputs(dtype)
        out = {"launches": {}}

        def step(name, fn):
            _build.reset_launch_counts()
            result = fn()
            torch.cuda.synchronize()
            out["launches"][name] = dict(_build.LAUNCHES)
            return result

        fit = step("fit", lambda: model.fit(data))
        out["nlml"] = step("log_likelihood", lambda: model.log_likelihood(data).item())
        out["pred"] = step("predict", lambda: fit.predict(xs).marginal())
        out["diff"] = step("predict differences", lambda: fit.predict(diffs).marginal())
        return out

    got, ref = run(np.float32), run(np.float64)

    def errors_of(r):
        return {"nlml": scalar_rel(r["nlml"], ref["nlml"]), "mean": max_rel(r["pred"].mean, ref["pred"].mean),
                "variance": max_rel(r["pred"].variance, ref["pred"].variance),
                "difference mean": max_rel(r["diff"].mean, ref["diff"].mean),
                "difference variance": max_rel(r["diff"].variance, ref["diff"].variance)}

    errors = errors_of(got)
    repeats = N_POS - len(np.unique(positions.astype(np.float32)))
    print(f"mixed features {N_POS} positions + {N_BIAS} bias ids: {repeats} repeated f32 positions; "
          f"log_likelihood f32 {got['nlml']!r}, f64 {ref['nlml']!r}")
    check_gates(f"mixed features N={N_POS + N_BIAS} f32 vs f64 on the card", errors, MIXED_TOLS)
    expected = {"fit": (1, 8), "log_likelihood": (1, 8), "predict": (1, 0), "predict differences": (2, 0)}
    for name, (grams, panels) in expected.items():
        check_counts(f"mixed features {name}", got["launches"][name],
                     {"radial_gram": grams, "radial_gram_diag": 0, "radial_gram_cols": 0, "panel_cholinv": panels})
    check_tf32_control(torch, "mixed features", lambda: errors_of(run(np.float32)), MIXED_TOLS)
    data, xs, diffs = inputs(np.float32)
    times = {"fit": wall_times(torch, lambda: model.fit(data), PHASE_REPS),
             "log_likelihood": wall_times(torch, lambda: model.log_likelihood(data), PHASE_REPS)}
    print(f"[{card}] mixed features N={N_POS + N_BIAS} f32 (median of {PHASE_REPS}, s): "
          + "; ".join(f"{k} {statistics.median(v):.4f} (all {v})" for k, v in times.items()))
    total = {k: sum(c[k] for c in got["launches"].values()) for k in got["launches"]["fit"]}
    return {"launches": total}


def check_batched_kernels(torch, np, card: str) -> dict:
    """The sampler's two batched kernel forms at full width, each against
    its plain batched version and, slice by slice, against the unbatched
    kernel (bit-equality printed; the gram's and the panel's tolerances
    gate), a non-SPD panel's NaN kept in its own slice, and each timed
    beside its bound."""
    from albatross_tpu_torch.ops.panel_cholinv import (
        panel_cholinv,
        panel_cholinv_batched,
        plain_panel_cholinv,
    )
    from albatross_tpu_torch.ops.radial_gram import (
        plain_radial_gram_diag_batched,
        radial_gram,
        radial_gram_diag_batched,
    )

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED + 2)
    x = torch.as_tensor(bench_data(np, N_SAMPLER, SEED + 2)[0], device=dev)
    ls = (LENGTH_SCALE * (0.8 + 0.4 * torch.rand(W_KERNEL, generator=g))).to(dev)
    sigma = (SIGMA * (0.8 + 0.4 * torch.rand(W_KERNEL, generator=g))).to(dev)
    diag = (NOISE**2 * (0.8 + 0.4 * torch.rand(W_KERNEL, generator=g)) + JITTER)[:, None].expand(
        W_KERNEL, N_SAMPLER).contiguous().to(dev)
    results = {}
    K = radial_gram_diag_batched(x, ls, sigma, diag, PROFILE)
    err = (K - plain_radial_gram_diag_batched(x, ls, sigma, diag, PROFILE)).abs().max().item()
    slice_err, equal = 0.0, True
    for w in range(W_KERNEL):
        one = radial_gram(x, x, ls[w].item(), sigma[w].item(), PROFILE, diag_add=diag[w])
        slice_err = max(slice_err, (K[w] - one).abs().max().item())
        equal &= bool(torch.equal(K[w], one))
    del K, one
    print(f"gram_diag batched ({W_KERNEL}, {N_SAMPLER}, {N_SAMPLER}) f32: max|kernel - plain| = {err:.3e}, "
          f"max|slice - unbatched kernel| = {slice_err:.3e} (tol {GRAM_F32_TOL:g}); slices bit-equal to the "
          f"unbatched kernel: {equal}")
    if not (err <= GRAM_F32_TOL * sigma.max().item() ** 2 and slice_err <= GRAM_F32_TOL * sigma.max().item() ** 2):
        fail(f"batched gram disagrees: plain {err}, unbatched {slice_err}")
    results["radial_gram_diag_batched"] = {
        "max_abs_err": err,
        "ms": cuda_ms(torch, lambda: radial_gram_diag_batched(x, ls, sigma, diag, PROFILE)),
        "plain_ms": cuda_ms(torch, lambda: plain_radial_gram_diag_batched(x, ls, sigma, diag, PROFILE),
                            reps=3, batch=2),
    }
    # every walker's (N, N) output written once; x, the scalars and the
    # diagonals read once; 7 operations an element at D = 1
    results["radial_gram_diag_batched"]["bound_ms"], results["radial_gram_diag_batched"]["bound_by"] = bound(
        4 * (W_KERNEL * N_SAMPLER * N_SAMPLER + N_SAMPLER + W_KERNEL * N_SAMPLER + 2 * W_KERNEL),
        W_KERNEL * N_SAMPLER * N_SAMPLER * 7)

    M = torch.randn((W_KERNEL, B_SAMPLER, B_SAMPLER), generator=g, dtype=torch.float64)
    A = (M @ M.mT + B_SAMPLER * torch.eye(B_SAMPLER, dtype=torch.float64)).float().to(dev)
    del M
    U, Wu = panel_cholinv_batched(A)
    Up, Wp = plain_panel_cholinv(A)
    rel = max((((U - Up).abs().amax((1, 2)) / Up.abs().amax((1, 2))).max().item()),
              (((Wu - Wp).abs().amax((1, 2)) / Wp.abs().amax((1, 2))).max().item()))
    abs_err = max((U - Up).abs().max().item(), (Wu - Wp).abs().max().item())
    slice_rel, equal = 0.0, True
    for w in range(W_KERNEL):
        Ui, Wi = panel_cholinv(A[w].contiguous())
        slice_rel = max(slice_rel, ((U[w] - Ui).abs().max() / Ui.abs().max()).item(),
                        ((Wu[w] - Wi).abs().max() / Wi.abs().max()).item())
        equal &= bool(torch.equal(U[w], Ui) and torch.equal(Wu[w], Wi))
    print(f"panel batched ({W_KERNEL}, {B_SAMPLER}, {B_SAMPLER}): relative to the max entry, kernel - plain "
          f"{rel:.3e}, slice - unbatched kernel {slice_rel:.3e} (tol {PANEL_PLAIN_TOL:g}); slices bit-equal to "
          f"the unbatched kernel: {equal}")
    if not (rel <= PANEL_PLAIN_TOL and slice_rel <= PANEL_PLAIN_TOL):
        fail(f"batched panel disagrees: plain {rel}, unbatched {slice_rel}")
    bad, slot = A.clone(), W_KERNEL // 2
    bad[slot, 5, 5] = -1.0
    nan_slots = [w for w in range(W_KERNEL) if torch.isnan(panel_cholinv_batched(bad)[0][w]).any().item()]
    print(f"panel batched: a non-SPD panel in slot {slot} gives NaN in slots {nan_slots}")
    if nan_slots != [slot]:
        fail(f"a non-SPD panel's NaN reached slots {nan_slots}")
    single_bound, _ = panel_bound(B_SAMPLER)
    results["panel_cholinv_batched"] = {
        "max_abs_err": abs_err,
        "ms": cuda_ms(torch, lambda: panel_cholinv_batched(A)),
        "plain_ms": cuda_ms(torch, lambda: plain_panel_cholinv(A)),
        "bound_ms": W_KERNEL * single_bound, "bound_by": "operations",
    }
    results["panel_cholinv_batched"]["single_ms"] = cuda_ms(torch, lambda: panel_cholinv(A[0].contiguous()))
    for name, r in results.items():
        print(f"[{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} of it)")
    print(f"[{card}] panel_cholinv one panel of the stack alone: {results['panel_cholinv_batched']['single_ms']:.4f} "
          f"ms, so {W_KERNEL} in turn {W_KERNEL * results['panel_cholinv_batched']['single_ms']:.4f} ms")
    return results


def check_sampler(torch, np, pt, _build, card: str, args) -> dict:
    """The ensemble sampler at N_SAMPLER on the bench model (the fused
    route: one batched gram launch and 8 batched panel calls an
    evaluation) and bench.py's row at N_SAMPLER_BENCH (the DSL route: one
    gram launch a walker, the batched library Cholesky)."""
    from albatross_tpu_torch.samplers import ensemble_sampler, ensemble_sampler_from_model, initial_params_from_jitter
    from albatross_tpu_torch.samplers.ensemble import model_log_prob_fn

    x_np, y_np = bench_data(np, N_SAMPLER, SEED + 2)
    model = bench_model(pt)
    data32 = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    data64 = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float64)
    walkers = initial_params_from_jitter(SEED + 2, model.get_tunable_parameters().values, W_SAMPLER)

    def batched_errors():
        got = model_log_prob_fn(model, data32)(walkers)
        return got, {"f64": max_rel(got, ref64), "per-walker f32": max_rel(got, per32)}

    walker_models = [model.set_tunable_params(w) for w in walkers]
    ref64 = torch.stack([m.log_likelihood(data64).cpu() for m in walker_models])
    per32 = torch.stack([m.log_likelihood(data32).cpu().double() for m in walker_models])
    _build.reset_launch_counts()
    got, errors = batched_errors()
    torch.cuda.synchronize()
    init_counts = dict(_build.LAUNCHES)
    print(f"sampler N={N_SAMPLER}: initial log-probs of {W_SAMPLER} walkers, batched f32 {got[:3].tolist()}..., "
          f"per-walker f64 {ref64[:3].tolist()}...; batched equal to the per-walker f32 route: "
          f"{bool(torch.equal(got, per32))}; launches {init_counts}")
    check_gates(f"sampler N={N_SAMPLER} batched f32 log-probs", errors, SAMPLER_TOLS)
    check_counts(f"sampler N={N_SAMPLER} one batched evaluation", init_counts,
                 {"radial_gram_diag_batched": 1, "panel_cholinv_batched": N_SAMPLER // B_SAMPLER,
                  "panel_cholinv": 0, "radial_gram": 0, "radial_gram_diag": 0})
    check_tf32_control(torch, f"sampler N={N_SAMPLER}", lambda: batched_errors()[1], SAMPLER_TOLS)

    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    chain = ensemble_sampler_from_model(model, data32, W_SAMPLER, SAMPLER_ITERATIONS, key=SEED + 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    rate = chain.acceptance_rate()
    evaluations = counts["radial_gram_diag_batched"]
    print(f"[{card}] sampler N={N_SAMPLER} f32, {W_SAMPLER} walkers, {SAMPLER_ITERATIONS} iterations: "
          f"{seconds:.3f} s with the initial evaluation, {W_SAMPLER * SAMPLER_ITERATIONS / seconds:.2f} "
          f"walker-steps/s; acceptance {rate:.3f}; peak device memory {peak:.2f} GiB; launches {counts}")
    if not (np.isfinite(chain.log_prob[-1]).all() and 0.0 < rate < 1.0
            and chain.params.shape == (SAMPLER_ITERATIONS + 1, W_SAMPLER, 3)):
        fail(f"sampler chain: acceptance {rate}, final log-probs {chain.log_prob[-1]}")
    if args.profile:
        half = model_log_prob_fn(model, data32)
        print_profile(torch, lambda: half(walkers[:W_SAMPLER // 2]),
                      f"sampler half-step evaluation N={N_SAMPLER}, {W_SAMPLER // 2} walkers", card, 2)
    if not (evaluations >= 1 + 2 * SAMPLER_ITERATIONS
            and counts["panel_cholinv_batched"] == evaluations * (N_SAMPLER // B_SAMPLER)
            and counts["panel_cholinv"] == 0 and counts["radial_gram"] == 0 and counts["radial_gram_diag"] == 0):
        fail(f"sampler launch counts {counts}")

    # bench.py's sampler row: its model, data and sizes, a warm-up chain first
    rng = np.random.default_rng(SEED + 9)
    xb = np.sort(rng.uniform(0.0, 10.0, N_SAMPLER_BENCH)).astype(np.float32)
    bench = pt.RegressionDataset.create(xb, np.sin(xb))
    smodel = pt.gp_from_covariance(pt.SquaredExponential(1.5, 1.0) + pt.IndependentNoise(0.1), jitter=1e-5)
    log_prob_fn = model_log_prob_fn(smodel, bench)
    init = initial_params_from_jitter(0, smodel.get_tunable_parameters().values, W_SAMPLER)
    ensemble_sampler(log_prob_fn, init, SAMPLER_BENCH_ITERATIONS, key=1)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    bchain = ensemble_sampler(log_prob_fn, init, SAMPLER_BENCH_ITERATIONS, key=1)
    torch.cuda.synchronize()
    bseconds = time.perf_counter() - t
    bcounts = dict(_build.LAUNCHES)
    print(f"[{card}] sampler bench row N={N_SAMPLER_BENCH} f32, {W_SAMPLER} walkers, {SAMPLER_BENCH_ITERATIONS} "
          f"iterations: {bseconds:.3f} s, {W_SAMPLER * SAMPLER_BENCH_ITERATIONS / bseconds:.1f} walker-steps/s; "
          f"acceptance {bchain.acceptance_rate():.3f}; launches {bcounts}")
    if not (np.isfinite(bchain.log_prob[-1]).all() and bcounts["radial_gram"] >= W_SAMPLER * (
            1 + SAMPLER_BENCH_ITERATIONS) and bcounts["panel_cholinv"] == 0 and bcounts["panel_cholinv_batched"] == 0):
        fail(f"sampler bench row: launches {bcounts}, final log-probs {bchain.log_prob[-1]}")
    return {"launches": counts, "bench_launches": bcounts, "split_launches": check_sampler_split(
        torch, np, pt, _build, card)}


def check_sampler_split(torch, np, pt, _build, card: str) -> dict:
    """W_SAMPLER walkers' batched log-probs at the main path's N, where one
    stack of their covariances would not fit on the card: the walkers run
    in batches that fit, every value finite, two walkers against their
    per-walker f32 route."""
    from albatross_tpu_torch.models.gp import GaussianProcess
    from albatross_tpu_torch.ops.batched_nlml import available_bytes, bytes_per_walker
    from albatross_tpu_torch.samplers import initial_params_from_jitter

    x_np, y_np = bench_data(np, N, SEED + 2)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    model = bench_model(pt)
    walkers = initial_params_from_jitter(SEED + 2, model.get_tunable_parameters().values, W_SAMPLER)
    models = [model.set_tunable_params(w) for w in walkers]
    dev = data.features.device
    stack, free = W_SAMPLER * bytes_per_walker(N, 4, dev), available_bytes(dev)
    if stack <= free:
        fail(f"sampler split: {W_SAMPLER} walkers at N={N} ({stack / 2**30:.1f} GiB) fit in "
             f"{free / 2**30:.1f} GiB: the check does not cross the card's memory")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t = time.perf_counter()
    got = GaussianProcess.batched_log_likelihood(models, data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per32 = torch.stack([models[w].log_likelihood(data).cpu().double() for w in (0, W_SAMPLER - 1)])
    errors = {"per-walker f32": max_rel(got[[0, W_SAMPLER - 1]], per32)}
    batches = counts["radial_gram_diag_batched"]
    print(f"[{card}] sampler split N={N} f32, {W_SAMPLER} walkers ({stack / 2**30:.1f} GiB as one stack, "
          f"{free / 2**30:.1f} GiB available): {batches} batches, {seconds:.3f} s, peak device memory "
          f"{peak:.2f} GiB; launches {counts}")
    check_gates(f"sampler split N={N} batched f32 log-probs", errors, SPLIT_TOL)
    if not (torch.isfinite(got).all() and batches >= 2 and counts["panel_cholinv_batched"] == batches * PANELS
            and counts["panel_cholinv"] == 0):
        fail(f"sampler split: launches {counts}, log-probs {got}")
    return counts


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
    # -- the serving side and the sparse GP --------------------------------
    fitc = check_fitc(torch, np, pt, _build, card, args)
    pitc = check_pitc(torch, np, pt, _build, card)
    phase_counts = {
        "fitc": fitc["launches"], "pitc": pitc["launches"], "sparse_update": pitc["update_launches"],
        "update": check_exact_update(torch, np, pt, _build, card, x_np, y_np, xs)["launches"],
        "serving": check_serving(torch, np, pt, _build, card, model, data, xs)["launches"],
        "safe": check_safe(torch, np, pt, _build, card, xs)["launches"],
        "fit_from_prediction": check_fit_from_prediction(torch, np, pt, _build, card, model, data, x_np,
                                                         y_np)["launches"],
        # -- the rest of the covariance DSL: composed kernels, RANSAC, mixed features
        "temperature": check_temperature(torch, np, pt, _build, card)["launches"],
        "mixed": check_mixed(torch, np, pt, _build, card)["launches"],
    }
    # -- the ensemble sampler: the walker-batched kernel forms --------------
    results.update(check_batched_kernels(torch, np, card))
    sampler = check_sampler(torch, np, pt, _build, card, args)
    phase_counts["sampler"] = sampler["launches"]
    phase_counts["sampler_bench"] = sampler["bench_launches"]
    phase_counts["sampler_split"] = sampler["split_launches"]

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            # the batched forms' own path is the sampler's
            "launches": sampler["launches"][name] if name.endswith("_batched") else path_counts[name],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a radial gram or a panel factor + inverse
            "value_grad_launches": grad_counts["launches"][name],
        }
        if name in grad_counts["backwards"]:
            entry["value_grad_backward_calls"] = grad_counts["backwards"][name]
        if "write_floor_ms" in r:
            entry["write_floor_ms"] = r["write_floor_ms"]
        entry.update({f"{phase}_launches": counts[name] for phase, counts in phase_counts.items()})
        if name == "radial_gram":  # the sparse GP's K_fu at (N_FITC, M_FITC)
            entry.update({f"fitc_cross_{k}": v for k, v in fitc["cross"].items()})
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
