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
of the path was launched, and times it.  Any failed check raises.
``--profile`` adds a torch.profiler breakdown of one NLML's device time.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is visible or the port's package is not beside this
script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
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
REPS = 5

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

SOURCES = {
    "radial_gram": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:81"),
    "radial_gram_diag": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "panel_cholinv": ("albatross_tpu_torch/csrc/panel_cholinv.cu", "albatross_tpu/ops/pallas_chol.py:121"),
}


def nlml_flops(n: int) -> float:
    """bench.py's count: Cholesky n^3/3 + whitening n^2 + gram 8 n^2."""
    return n**3 / 3.0 + n * n + 8.0 * n * n


def fail(message: str) -> None:
    raise RuntimeError(f"chip_smoke check failed: {message}")


def cuda_ms(torch, fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn`` on the card (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def profile_nlml(torch, model, data, card: str, evals: int = 2) -> None:
    """Where the NLML's device time goes: torch.profiler over ``evals``
    evaluations, device kernels only, per eval, plus the device idle share
    against host wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(evals):
            model.log_likelihood(data)
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
    print(f"[{card}] profile of {evals} NLML evals: wall {wall_ms:.1f} ms, device kernels "
          f"{device_us / 1e3:.1f} ms, device idle share {1 - device_us / 1e3 / wall_ms:.4f}")
    for us, key, count in sorted(rows, reverse=True)[:16]:
        print(f"  {us / 1e3 / evals:9.3f} ms/eval  {count // evals:5d} launches/eval  {key[:100]}")


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
    from albatross_tpu_torch import _build
    from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv, plain_panel_cholinv
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram, radial_gram

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    for name in _build.KERNELS:
        _build.load(name)
        seconds, log = _build.build_info(name)
        ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"build {name}: {seconds:.1f} s; " + " | ".join(ptxas))
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
    profile = "squared_exponential"
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
    Up, Wp = plain_panel_cholinv(A)
    U, Wu = panel_cholinv(A)
    err = max((U - Up).abs().max().item(), (Wu - Wp).abs().max().item())
    eu = ((U - Up).abs().max() / Up.abs().max()).item()
    ew = ((Wu - Wp).abs().max() / Wp.abs().max()).item()
    print(f"panel b=1024: max|kernel - plain| = {err:.3e}; relative to the max entry "
          f"U {eu:.3e}, Wu {ew:.3e} (tol {PANEL_PLAIN_TOL:g})")
    if not (eu <= PANEL_PLAIN_TOL and ew <= PANEL_PLAIN_TOL):
        fail("panel kernel disagrees with its plain version at b=1024")
    results["panel_cholinv"] = {"max_abs_err": err}

    # -- the main path, through the public API -----------------------------
    kernel = pt.SquaredExponential(LENGTH_SCALE, SIGMA) + pt.measurement_only(
        pt.IndependentNoise(NOISE, assume_unique=True)
    )
    model = pt.gp_from_covariance(kernel, jitter=JITTER)
    data = pt.RegressionDataset.create(x_np, y_np, device="cuda", dtype=torch.float32)

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
    if nlml_counts["radial_gram_diag"] != 1 or nlml_counts["panel_cholinv"] != PANELS:
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
    for name, r in results.items():
        print(f"[{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms")
    if args.profile:
        profile_nlml(torch, model, data, card)

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
