#!/usr/bin/env python3
"""Drive the PyTorch port's exact-GP main path once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the hand-written CUDA kernels from ``albatross_tpu_torch/csrc``,
holds each against its plain PyTorch version on the card at the main
path's shapes (the trailing-update kernel also against f64 and cuBLAS's
``addmm_`` loop, at 27, 13 and 1 later column panels of 1024; the
whitening kernel of a prediction's variance against f64, its one-solve
plain form and the two cuBLAS trsm it replaced), then runs
the main path through the public API at full
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
calls are counted and it is timed; at N = 28672 its trailing-update
launches are counted (one a panel forward and backward) and it is timed
with its peak memory; a 10-iteration L-BFGS run of ``get_tuner`` at N = 8192 must lower
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
the unbatched kernels (the panel form also against the batched library
pair, and timed over W = 1, 4, 16, the batch the split at N = 28672 takes
and 32, with the grid and schedule each call launched), then runs the
ensemble sampler through
``ensemble_sampler_from_model`` at N = 8192 with 32 walkers (its batched
f32 log-probs against the per-walker f64 log_likelihood on the card, with
a TF32 control, and against the per-walker f32 route; walker-steps/s,
peak memory, launch counts), bench.py's sampler row (N = 1024, 32
walkers, 64 iterations) and 32 walkers' batched log-probs at N = 28672,
more than the card holds as one stack, which run in batches that fit.
The last phases hold the error-free transforms exact on the card, run
the NLML accuracy modes at N = 28672 (plain, compensated, double-word,
both: each against the f64 NLML and the f64 NLML of the f32 covariance,
s/eval, peak memory, a TF32 control; the plain and double-word loops'
log-det and quadratic term below the f32 NLML's last digit; the f32 sum
of logs three ways; value+grad at N = 8192 under each mode), and the
distributed GP (``parallel``) on an NCCL world of one rank at N = 28672
and on a gloo world of 4 processes sharing the card at N = 8192 (NLML,
fit + predict, LOO, LOGO, value+grad, the walker-sharded sampler), each
against the single-process GP on the card; in the same worlds the 2-D
tile layout, on a (1, 1) mesh at N = 28672 (NLML, fit + predict, LOO; the
panel kernel on every panel step, times, peak memory) and on a (2, 2)
mesh of the 4 ranks at N = 8192 (NLML, value+grad, fit + predict, LOO,
LOGO, an update; each rank's tile and peak memory, and no op writing an
N x N tensor), and the distributed sparse GP, FITC at N = 131072 with
4096 inducing points on the NCCL rank (the TSQR's |diag R| against the
f64 data's) and FITC and PITC at N = 32768 (400 groups, some straddling
the ranks' rows) with value+grad on the gloo ranks, each against the
single process.  Phase (h) runs the port's examples and tutorials
through their ``run()`` on the card: sinc (its radial_only model, and the
parametric model tuned by L-BFGS on the LOO likelihood), the sparse
example, the sampler example at N = 8192 with 32 walkers, the accuracy
example at N = 28672 and the distributed example on its own (4, 2) mesh
of 8 gloo ranks sharing the card, each f32 run against the same run() in
f64 on the card at the largest size where the example's own model still
factors in f32, and the inspection example and the five tutorials in f64
against the CPU; each prints its seconds, errors and kernel launches.
Phase (i) runs a 32-feature GP on the gram kernel's high-D branch (f32,
D >= 8: a 3xTF32 tensor-core contraction of per-tile centred coordinates
with an exact recompute of the tiles inside the profile's support),
SquaredExponential(2.0) + noise on X = 1000 + t u + 0.05 xi: the four
launch forms at the path's shapes against ``plain_radial_gram_tiled``
and f64 (refined share, bitwise symmetry, the column blocks and walker
slices bit-equal to the materialized and unbatched kernel; times beside
the bound and torch.cdist + the profile), NLML and fit + predict of 4096
points at N = 28672 against f64 on the card with a single-pass TF32 and
an uncentred cdist control, value+grad there with the backward's blocked
d^2 launches (checked against ``tiled_squared_distances``) and with the
closed form (time, peak memory), value+grad and the ensemble sampler at
N = 8192, the lazy NLML and value+grad (both backwards) at N = 57344, and
a sweep of D = 8, 16, 32, 64 on bench.py's high-D data and the slice's
law, the branch timed in turns with the elementwise loop on the same
inputs (the design before it).  The D = 1 main path's grams must hash as
they did before the high-D branch; the elementwise loop's staged
instance (f32 at D = 5-7) is held against f64 and timed at D = 7.
Any failed check raises.  Each kernel's time is printed
beside its bound (the least time the card could take for the same work);
the gram kernels also beside the card's write floor, a ``fill_`` of a
buffer of the gram's shape.
``--profile`` adds a torch.profiler breakdown of one NLML's device time and
of one value+grad evaluation's, forward and backward apart, of one
lazy NLML at N = 57344, of one FITC fit, of one batched panel call at
W = 16 by kernel name with the device's idle share between launches, of
one sampler half-step's batched evaluation, and of one NLML under the
plain, double-word and compensated modes.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, when no GPU is visible or the port's package is not beside this
script.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
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
TRAIL_B = 1024     # the trailing-update phase: panel width and later column panels a launch
TRAIL_PANELS = (27, 13, 1)
TRAIL_F64_TIMES = 4.0   # the kernel's error against f64 within this many times cuBLAS FP32's
TRAIL_PLAIN_TOL = 1e-5  # kernel against its plain version, over the largest f64 entry
WHITEN_F32_TIMES = 3.0  # the whitening kernel's error against f64 within this many times cuBLAS's f32 solve's
WHITEN_PLAIN_TOL = 1e-5  # the whitening kernel against its split-product plain version, over the largest f64 entry
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
# The accuracy modes (config.NLML_COMPENSATED, CHOLESKY_PRECISION =
# "double_word") at the main path's N and, value+grad, at N_GRAD; the
# error-free transforms on N_EFT random f32 pairs.  The distributed GP:
# an NCCL world of one rank at the main path's N, and a gloo world of
# DIST_WORLD processes sharing the card at N_DIST (a LOGO of N_DIST /
# CV_GROUP groups, DIST_WALKERS walkers for DIST_ITERATIONS iterations),
# on a jittered strict grid, unique in f32 (benchmarks/exp_2d_bigN.py):
# the bench draw repeats a dozen f32 values at N, and the sharded gram's
# noise compares features by value (a duplicated pair is singular there).
N_EFT = 1 << 20
MODE_REPS = 3
N_DIST, DIST_WORLD, DIST_WALKERS, DIST_ITERATIONS = 8192, 4, 32, 4
DIST_TIMEOUT = 600  # seconds the gloo world may take before its ranks are killed
# The 2-D tile layout: a (1, 1) ("data", "model") mesh on the NCCL world of
# one at the main path's N, and a DIST_2D_SHAPE mesh over the same gloo
# ranks at N_DIST (its update fits the first DIST_UPDATE_FIRST points, then
# the rest).  The distributed sparse GP: FITC's cell (N_FITC, M_FITC) on
# the world of one; FITC and PITC at PITC's cell (N_PITC, M_PITC, about
# 400 groups, which straddle the ranks' rows) in the gloo world.
DIST_2D_SHAPE = (2, 2)
DIST_UPDATE_FIRST = 6144
# Phase (h), the port's examples and tutorials through their run() on the
# card, f32 against the same run() in f64 on the card, each at the largest
# size where the example's own model still factors in f32 (PERF.md section
# 4): sinc's radial_only model at EX_SINC_N (sigma 100 over noise 1: NaN
# from 2560, read at EX_SINC_NAN_N each run); the parametric sinc model
# tuned by L-BFGS on the LOO likelihood at EX_TUNE_N (from 3584 the f32
# inputs repeat a value, which the by-value noise makes singular); the
# sparse example at EX_SPARSE_N with EX_M inducing points (K_uu NaNs from
# 32, the f32 inputs repeat from 10240); the sampler example at N_SAMPLER
# with W_SAMPLER walkers, SAMPLER_ITERATIONS iterations and EX_BURN_IN of
# burn-in; the accuracy example at EX_N against its own f64 oracle; the
# distributed example on its own (4, 2) mesh over EX_RANKS gloo ranks
# sharing the card at N_DIST, f64 as the JAX example (its own
# single-process checks); the inspection example and the tutorials as
# written, f64 on the card against the CPU.
EX_N, EX_SINC_N, EX_SINC_NAN_N, EX_TUNE_N = 28672, 2048, (2560, 28672), 3072
EX_SPARSE_N, EX_M, EX_BURN_IN, EX_RANKS = 8192, 24, 8, 8
# where the examples' models stop holding in f32, read (not gated) each
# run: sinc's radial model (the polynomial's sigma 100) at these n, the
# sparse example at EX_SPARSE_N with these inducing counts
EX_RADIAL_N, EX_M_NAN = (20, 100), (32, 2048)
EX_SMALL = ("examples.inspection", "tutorials.tutorial_1_one_dimension", "tutorials.tutorial_2_maximum_likelihood",
            "tutorials.tutorial_3_sparse", "tutorials.tutorial_4_state_space",
            "tutorials.tutorial_5_evaluating_uncertainty")
# NVIDIA's data sheet for the H100 SXM: device memory rate, and the FP32
# rate outside the tensor cores (the panel kernel and the low-D grams use
# no tensor cores).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 494.7e12  # dense, the tensor cores (NVIDIA's H100 SXM data sheet)
PROFILE_OPS = 7  # FP32 operations an element for a radial profile (the high-D bound)

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

# The accuracy modes' f32 NLML at N against the f64 NLML on the card and
# against the f64 NLML of the f32 covariance ("rounded"), relative: about
# 10x the first reading on H100 (plain and double-word 9.49e-7 / 1.88e-7,
# the same f32 value; compensated and both 1.13e-6 / 1.28e-8, the f32
# result's own rounding), so the TF32 control (5.0e-5) fails them; their
# value+grad at N_GRAD takes the value+grad phase's gates.  The distributed
# GP against the single-process GP on the same f32 data on the card, the
# largest error over the largest single-process entry: on a world of one
# rank both run the same factorization and solves, bit for bit (read 0;
# gated at 1e-7, about one f32 ulp; the single process's variance by its
# factor's two solves, as the distributed GP forms it, where its own
# marginal prediction takes the whitening kernel); on the gloo world of 4 about 10x the
# first reading (other block sizes and summation orders).
MODE_TOLS = {"plain": 9.5e-6, "compensated": 1.2e-5, "double_word": 9.5e-6, "both": 1.2e-5,
             "plain rounded": 1.9e-6, "compensated rounded": 1.3e-7, "double_word rounded": 1.9e-6,
             "both rounded": 1.3e-7}
DIST_ONE_TOLS = {"nlml": 1e-7, "mean": 1e-7, "variance": 1e-7, "loo mean": 1e-7, "loo variance": 1e-7}
DIST_FOUR_TOLS = {"nlml": 8.9e-6, "mean": 4.6e-5, "variance": 1.8e-4, "loo mean": 2.4e-5, "loo variance": 4.2e-5,
                  "logo mean": 1.2e-4, "logo covariance": 1.1e-4, "value": 8.9e-6, "gradient": 2.5e-7,
                  "sampler": 1.1e-7}
# The 2-D layout and the distributed sparse GP against the single process
# on the same f32 data on the card, about 10x their first readings (a
# reading of 0 gated at 1e-7, about one f32 ulp, as world 1's).  The 2-D
# factor equals the single process's (the NLML reads 0); predict's 4096
# and update's 2048 right-hand sides go through W = L^-1 (the JAX
# package's ``auto`` route from 32), whose f32 explicit inverse reads
# 3.9e-4 in the variance at N = 28672 and 2.7e-3 in the update's mean.
# The distributed sparse fit takes v and the NLML from R^-T B^T y in f64
# where the single process applies Q^T.
DIST_2D_ONE_TOLS = {"nlml": 1e-7, "mean": 1.1e-4, "variance": 3.9e-3, "loo mean": 7.7e-5, "loo variance": 8.3e-5}
DIST_2D_FOUR_TOLS = {"nlml": 1e-7, "mean": 4.1e-5, "variance": 5e-4, "loo mean": 3e-5, "loo variance": 4.1e-5,
                     "logo mean": 2.1e-4, "logo covariance": 2e-4, "value": 1e-7, "gradient": 9.2e-8,
                     "update mean": 2.7e-2, "update variance": 7.5e-4}
DIST_SPARSE_ONE_TOLS = {"mean": 9.2e-6, "variance": 6.8e-5, "nlml": 2.9e-5}
DIST_SPARSE_FOUR_TOLS = {"fitc mean": 9.7e-6, "fitc variance": 1e-7, "fitc nlml": 1.8e-5, "fitc value": 1.8e-5,
                         "fitc gradient": 2e-5, "pitc mean": 1e-5, "pitc variance": 1e-7, "pitc nlml": 5.1e-5,
                         "pitc value": 5.1e-5, "pitc gradient": 1.2e-5}

# Phase (h)'s gates: f32 against f64 on the card, each error the largest
# |f32 - f64| over the largest |f64| entry (relative for a scalar), about
# 10x the first reading on H100 (PERF.md section 2).  The small examples
# and tutorials run f64 on the card and on the CPU: 1e-9 relative, as the
# f64 phase, with an absolute floor of 1e-12 for rounding residues (an
# update against a refit, an eigenvalue of 3e-16); printed text equal, its
# numbers within one unit of their last printed digit.
EX_TOLS = {  # the comments: first readings, NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6)
    # 1.286e-3, 3.131e-3, 5.046e-3, 2.357e-2: kappa 3.8e6, so eps_f32 kappa = 0.23
    "sinc_radial_only": {"nlml": 1.3e-2, "rmse": 3.1e-2, "mean": 5e-2, "variance": 0.24},
    # 4.836e-8, 4.815e-8
    "sinc_parametric_tuned": {"objective at the f32 optimum": 4.8e-7, "tuned objective": 4.8e-7},
    # 5.624e-6, 1.812e-3, 1.698e-4, 6.394e-5
    "sparse": {"sparse mean": 5.6e-5, "sparse variance": 1.8e-2, "exact mean": 1.7e-3, "nlml": 6.4e-4},
    "sampler": {"tuned nlml": 3.7e-4},  # 3.668e-5
    # 6.527e-6, 2.628e-7, 2.628e-7, 5.749e-7
    "accuracy": {"plain f32": 6.5e-5, "compensated": 2.6e-6, "compensated + chol=highest": 2.6e-6,
                 "compensated + chol=double_word": 5.7e-6},
}
EX_CPU_RTOL, EX_CPU_FLOOR = 1e-9, 1e-12

# Phase (i), the gram kernel's high-D branch: a 32-feature GP through the
# public API, SquaredExponential(HD_LENGTH_SCALE, SIGMA) +
# measurement_only(IndependentNoise(NOISE)), jitter JITTER, on
# X = 1000 + t u + 0.05 xi (t sorted on [0, 100], u a unit vector, xi ~
# N(0, I)), y = sin(0.3 t) + 0.1 noise, numpy seed HD_SEED; the sampler at
# N_SAMPLER with W_SAMPLER walkers, 16 a half-step, HD_SAMPLER_ITERATIONS.
HD_D, HD_LENGTH_SCALE, HD_SEED, HD_SAMPLER_ITERATIONS = 32, 2.0, 5, 4
# Its gates, against f64 on the card (the f64 gram keeps the exact loop at
# every D), about 10x the first reading (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md section 6): the largest |f32 - f64| of the training covariance
# and the cross covariance (1.60e-7, 1.46e-7: the profile's f32 rounding
# in the exact near tiles) and over the tiles left to the contraction
# (1.21e-9, 1.00e-9; a single-pass TF32 contraction reads 9.4e-7 and
# 6.4e-7 there and fails them); the NLML (relative, 6.81e-7), the predicted
# mean and variance (absolute, 3.79e-5, 5.65e-7); value+grad at N_GRAD
# (relative 1.59e-6; the gradient over its largest entry, 8.90e-7); the
# sampler's initial batched log-probs against the per-walker f64 and f32
# log_likelihood (5.53e-5, 2.27e-5: the f32 factorizations of the jittered
# walkers) and the lazy NLML at N_LAZY (5.98e-7; the lazy value+grad's
# value takes its gate, the same forward).  The uncentred cdist
# control's covariance is 1.0 off and its factorization NaN.
HD_TOLS = {"covariance": 1.6e-6, "covariance far field": 1.1e-8, "cross": 1.5e-6, "cross far field": 1.1e-8,
           "nlml": 6.9e-6, "mean": 3.8e-4, "variance": 5.9e-6, "value": 1.6e-5, "gradient": 9e-6, "sampler": 5.6e-4,
           "sampler per-walker f32": 2.3e-4, "lazy nlml": 6e-6, "lazy value+grad value": 6e-6}
# The backward's d^2 launches against tiled_squared_distances, relative to
# the block's largest d^2: the far field's two contractions (3xTF32, and
# torch.matmul's FP32) each lose a few f32 ulp of |x - c|^2 + |y - c|^2,
# the near tiles' exact sums differ in their order; a few 1e-7 expected.
HD_D2_REL_TOL = 1e-6
# The lazy value+grad's gradient by the d^2 launches against the closed
# form's, relative to its largest entry: both f32, as the gradient gate.
HD_LAZY_GRAD_ROUTES_TOL = 9e-6
# The sweep: feature counts, and the loop's repeats in turns with the branch
HD_SWEEP_D = (8, 16, 32, 64)
# sha256 of the D = 1 main path's training covariance and cross covariance
# from the kernel before its high-D branch (commit c33de6f, the same check
# on NVIDIA H100 80GB HBM3): the low-D code keeps its bits
MAIN_PATH_SHA256 = {"covariance": "0ef94291f0b9a3b5c01ae54de60e931bbd5c1b6194ba4e8ffcf041e181a20ac3",
                    "cross": "f295cbe18613884b164ef35a0f3f1035dcfece5450e9a8776ce701cf996d5f91"}
# sha256 of phase (i)'s training covariance and cross covariance from the
# first tensor-core design (commit f528a61, on NVIDIA H100 80GB HBM3): the
# far tiles' bits changed with the contraction (wgmma), printed beside
# the current ones; the near tiles keep the elementwise loop's bits
HD_FIRST_DESIGN_SHA256 = {"covariance": "4a53b0eb582fbdc17d33d9451a05c9665d92039d0349b83cba5a9cec740b1166",
                  "cross": "d1ed49ccb6931bc8e300aa84951a1a2340c43e2dd705b22d90a2f303509977f5"}
# the phase's kernel rows: the high-D branch of each launch form
HD_SOURCES = {
    "radial_gram_highd": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:81"),
    "radial_gram_diag_highd": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "radial_gram_cols_highd": ("albatross_tpu_torch/csrc/radial_gram.cu", "albatross_tpu/ops/pallas_gram.py:137"),
    "radial_gram_diag_batched_highd": ("albatross_tpu_torch/csrc/radial_gram.cu",
                                       "albatross_tpu/ops/pallas_gram.py:137"),
}

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


def ptxas_kernel(log: str, name: str) -> str:
    """Registers, shared memory and spills of the kernel whose mangled name
    holds ``name``, from ``-Xptxas -v``: its entry's line and the spills of
    the device functions compiled with it."""
    for section in log.split("Compiling entry function '")[1:]:
        if name not in section.split("'")[0]:
            continue
        regs = re.search(r"Used (\d+) registers", section)
        smem = re.search(r"(\d+) bytes smem", section)
        stores = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", section))
        loads = sum(int(x) for x in re.findall(r"(\d+) bytes spill loads", section))
        return (f"{name}: {regs.group(1) if regs else '?'} registers a thread, {smem.group(1) if smem else 0} bytes "
                f"static shared memory, spills {stores} bytes stored / {loads} bytes loaded (with its device functions)")
    return f"{name}: no ptxas report"


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


def print_launch_breakdown(torch, fn, what: str, card: str, calls: int) -> dict:
    """One call of ``fn`` by kernel name, and the device's idle share
    between its launches: torch.profiler over ``calls`` back-to-back calls
    after a warm-up, each kernel's and copy's device time and launches
    summed by name; the idle share is the part of the span from the first
    launch's start to the last one's end that no kernel or copy covers,
    read from the timeline when it holds every launch the sums count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows, launches = [], 0
    for e in prof.key_averages():
        if "CUDA" not in str(e.device_type):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us, re.sub(r"\(.*$", "", re.sub(r"^void |\(anonymous namespace\)::", "", e.key)), e.count))
            launches += e.count
    if not rows:
        fail("torch.profiler recorded no device time")
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "CUDA" in str(e.device_type) and e.time_range.end > e.time_range.start)
    busy_us = sum(us for us, _, _ in rows)
    line = f"[{card}] launches of {what}, per call over {calls}: {launches / calls:.1f} launches, busy {busy_us / 1e3 / calls:.4f} ms"
    out = {"busy_ms": busy_us / 1e3 / calls, "launches": launches / calls, "span_ms": None, "idle_share": None}
    if len(spans) == launches:
        covered, end = 0.0, spans[0][0]
        for start, stop in spans:
            if stop > end:
                covered += stop - max(start, end)
                end = stop
        span = end - spans[0][0]
        out["span_ms"], out["idle_share"] = span / 1e3 / calls, 1.0 - covered / span
        line += f", span {span / 1e3 / calls:.4f} ms, device idle share between launches {out['idle_share']:.4f}"
    else:
        line += f"; the timeline holds {len(spans)} of the {launches} launches: idle share not measured"
    print(line)
    for us, short, count in sorted(rows, reverse=True):
        print(f"  {us / 1e3 / calls:9.4f} ms/call  {count / calls:6.1f} launches/call  {short[:90]}")
    return out


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
            or counts["radial_gram_cols"] != 0 or backwards["panel_cholinv"] != PANELS_GRAD
            or counts["trailing_update"] != PANELS_GRAD - 1
            or counts["trailing_update_backward"] != PANELS_GRAD - 1):
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
            or lazy_counts["panel_cholinv"] != PANELS_GRAD or lazy_backwards["panel_cholinv"] != PANELS_GRAD
            or lazy_counts["trailing_update"] != PANELS_GRAD - 1
            or lazy_counts["trailing_update_backward"] != PANELS_GRAD - 1):
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


def time_value_grad_big(torch, _build, model, data, card: str, args) -> None:
    """value+grad at the main path's N: the trailing-update kernel's launches
    (one a panel forward and backward), s/eval, TFLOP/s by bench.py's
    3x-forward accounting, and the evaluation's peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    value_grad(torch, model, data)  # warm-up, the memory reading and the trailing kernel's engagement
    peak = torch.cuda.max_memory_allocated()
    engaged = {k: _build.LAUNCHES[k] for k in ("trailing_update", "trailing_update_backward")}
    print(f"value+grad N={N}: trailing-update launches {engaged} for the {PANELS - 1} panels with a trailing "
          f"update, {sum(engaged.values()) / (2 * (PANELS - 1)):.0%} of them")
    if engaged != {"trailing_update": PANELS - 1, "trailing_update_backward": PANELS - 1}:
        fail(f"value+grad N={N} did not run every trailing update on the kernel: {engaged}")
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
    # the process's first multi-threaded CPU exp can differ from every later
    # one (ROADMAP.md's watch list: a 1.1e-9 difference in this NLML on an
    # H100 host, against 4.9e-15 otherwise): the reference is the second
    # evaluation
    model.log_likelihood(on_cpu)
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


def check_batched_kernels(torch, np, card: str, profile: bool) -> dict:
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
    bad, slots = A.clone(), [0, W_KERNEL // 2, W_KERNEL - 1]
    for slot in slots:
        bad[slot, 5, 5] = -1.0
    nan_slots = [w for w in range(W_KERNEL) if torch.isnan(panel_cholinv_batched(bad)[0][w]).any().item()]
    print(f"panel batched: non-SPD panels in slots {slots} give NaN in slots {nan_slots}")
    if nan_slots != slots:
        fail(f"a non-SPD panel's NaN reached slots {nan_slots}")
    single_bound, _ = panel_bound(B_SAMPLER)
    eye = torch.eye(B_SAMPLER, dtype=A.dtype, device=dev)
    results["panel_cholinv_batched"] = {
        "max_abs_err": abs_err,
        "ms": cuda_ms(torch, lambda: panel_cholinv_batched(A)),
        "plain_ms": cuda_ms(torch, lambda: plain_panel_cholinv(A)),
        "bound_ms": W_KERNEL * single_bound, "bound_by": "operations",
        # the batched library pair: cuSOLVER's potrf, then a trsm against the identity
        "library_two_call_ms": cuda_ms(torch, lambda: torch.linalg.solve_triangular(
            torch.linalg.cholesky(A), eye, upper=False)),
    }
    results["panel_cholinv_batched"]["single_ms"] = cuda_ms(torch, lambda: panel_cholinv(A[0].contiguous()))
    if profile:
        print_launch_breakdown(torch, lambda: panel_cholinv_batched(A),
                               f"panel_cholinv_batched ({W_KERNEL}, {B_SAMPLER}, {B_SAMPLER})", card, 10)
    for name, r in results.items():
        print(f"[{card}] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} of it)")
    r = results["panel_cholinv_batched"]
    print(f"[{card}] panel_cholinv_batched ({W_KERNEL}, {B_SAMPLER}, {B_SAMPLER}): the batched library pair "
          f"(torch.linalg.cholesky + solve_triangular against the identity) {r['library_two_call_ms']:.4f} ms; "
          f"one panel of the stack alone through panel_cholinv {r['single_ms']:.4f} ms, so {W_KERNEL} in turn "
          f"{W_KERNEL * r['single_ms']:.4f} ms")
    r["sweep"] = batched_panel_sweep(torch, card, g, dev, single_bound, r["single_ms"])
    return results


def batched_panel_sweep(torch, card: str, g, dev, single_bound: float, single_ms: float) -> list:
    """The batched panel kernel at b = B_SAMPLER over the batch sizes of its
    callers: one walker, a gloo rank's 4, the sampler's half of 16, the
    batch the split at the main path's N takes, and 32; each timed beside
    its bound with the plan it launched (W = 1 also beside the single-panel
    kernel, as a reading: the single panel does not take this route)."""
    from albatross_tpu_torch.ops.batched_nlml import walkers_per_batch
    from albatross_tpu_torch.ops.panel_cholinv import batched_plan, panel_cholinv_batched

    split = walkers_per_batch(W_SAMPLER, N, 4, dev)
    rows = []
    for w in sorted({1, 4, W_KERNEL, split, 2 * W_KERNEL}):
        M = torch.randn((w, B_SAMPLER, B_SAMPLER), generator=g, dtype=torch.float64)
        A = (M @ M.mT + B_SAMPLER * torch.eye(B_SAMPLER, dtype=torch.float64)).float().to(dev)
        del M
        ms = cuda_ms(torch, lambda: panel_cholinv_batched(A))
        row = {"w": w, "ms": ms, "bound_ms": w * single_bound, "plan": batched_plan(B_SAMPLER, w)}
        rows.append(row)
        print(f"[{card}] panel_cholinv_batched W={w}{' (the split at N=%d)' % N if w == split else ''}: {ms:.4f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_ms'] / ms:.1%} of it); plan {row['plan']}"
              + (f"; the single-panel kernel {single_ms:.4f} ms" if w == 1 else ""))
        del A
    return rows


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


def check_eft(torch, card: str) -> None:
    """The error-free transforms on the card: for N_EFT random f32 pairs,
    a + b == s + e and a b == p + e exactly in f64 (eager launches do not
    contract a multiply and its add into an FMA); dw_sum of them against
    the f64 sum."""
    from albatross_tpu_torch.ops.compensated import dw_sum, two_prod, two_sum

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(SEED)
    a = (1e3 * torch.randn(N_EFT, generator=g)).cuda()
    b = torch.randn(N_EFT, generator=g).cuda()
    s, e = two_sum(a, b)
    sum_bad = int(((s.double() + e.double()) != (a.double() + b.double())).sum())
    p, e = two_prod(a, b)
    prod_bad = int(((p.double() + e.double()) != (a.double() * b.double())).sum())
    h, l = dw_sum(a)
    exact = a.double().sum().item()
    dw_err = abs(h.item() + l.item() - exact) / a.double().abs().sum().item()
    plain_err = abs(a.sum().item() - exact) / a.double().abs().sum().item()
    torch.cuda.synchronize()
    print(f"[{card}] EFT canary on {N_EFT} f32 pairs: two_sum inexact {sum_bad}, two_prod inexact {prod_bad}; "
          f"dw_sum error {dw_err:.3e} (plain f32 sum {plain_err:.3e}) of sum|a|; {time.perf_counter() - t0:.2f} s")
    if sum_bad or prod_bad or not dw_err <= 1e-12:
        fail(f"the error-free transforms are not exact on the card: {sum_bad}, {prod_bad}, {dw_err}")


def _set_modes(config, compensated: bool, precision) -> None:
    config.NLML_COMPENSATED = compensated
    config.CHOLESKY_PRECISION = precision


def check_accuracy_modes(torch, np, pt, _build, config, card: str, data, ll_ref: float, args) -> dict:
    """The NLML accuracy modes at the main path's N (bench model, seed 0,
    f32): plain, compensated, double-word and both, each against the f64
    NLML on the card, its s/eval (median of MODE_REPS) and peak memory,
    with a TF32 control on the most accurate mode; the f32 sum of logs of
    the factor's diagonal three ways against f64 (is the card's f32 log
    biased?); value+grad under each mode at N_GRAD.  Returns the modes'
    launch counts."""
    from albatross_tpu_torch.ops.blocked_cholesky import blocked_cholesky_cols
    from albatross_tpu_torch.ops.compensated import accurate_log, blocked_cholesky_dw, dw_sum, two_prod
    from albatross_tpu_torch.ops.linalg import CholeskyFactor
    from albatross_tpu_torch.ops.radial_gram import plain_radial_gram

    t0 = time.perf_counter()
    model = bench_model(pt)
    modes = {"plain": (False, None), "compensated": (True, None), "double_word": (False, "double_word"),
             "both": (True, "double_word")}
    # the f64 NLML of the f32 training covariance itself: what the modes
    # compute more exactly (the f64 reference's own gram differs from it by
    # the f32 rounding of each entry, which no mode can undo)
    cov, fused = model._training_covariance(pt.kernels.as_measurement(data.features), None)
    L64 = torch.linalg.cholesky(cov.double() + (0.0 if fused else JITTER) * torch.eye(N, dtype=torch.float64,
                                                                                     device=cov.device))
    white = torch.linalg.solve_triangular(L64, data.targets.mean.double()[:, None], upper=False)[:, 0]
    terms64 = {"log-det": 2.0 * torch.log(L64.diagonal()).sum().item(), "quadratic": (white @ white).item()}
    ll_rounded = -0.5 * (terms64["log-det"] + terms64["quadratic"] + N * math.log(2 * math.pi))
    del L64, white
    errors, counts = {}, {}
    _build.reset_launch_counts()
    try:
        for name, mode in modes.items():
            _set_modes(config, *mode)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = dict(_build.LAUNCHES)
            ll = model.log_likelihood(data)
            torch.cuda.synchronize()
            counts[name] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
            times = wall_times(torch, lambda: model.log_likelihood(data), MODE_REPS)
            peak = torch.cuda.max_memory_allocated() / 2**30
            errors[name] = scalar_rel(ll.item(), ll_ref)
            errors[f"{name} rounded"] = scalar_rel(ll.item(), ll_rounded)
            print(f"[{card}] NLML N={N} f32 {name}: {ll.item()!r}, rel err vs f64 {errors[name]:.3e}, vs the f64 "
                  f"NLML of the f32 covariance {errors[f'{name} rounded']:.3e}; "
                  f"{statistics.median(times):.4f} s/eval (median of {MODE_REPS}; all {times}); peak "
                  f"{peak:.2f} GiB; launches {counts[name]}")
        phase_counts = dict(_build.LAUNCHES)

        def both_errors():
            ll = model.log_likelihood(data).item()
            return {"both": scalar_rel(ll, ll_ref), "both rounded": scalar_rel(ll, ll_rounded)}

        if args.profile:
            for name in ("plain", "double_word", "compensated"):
                _set_modes(config, *modes[name])
                print_profile(torch, lambda: model.log_likelihood(data), f"NLML N={N} {name}", card, 2)
            _set_modes(config, *modes["both"])  # the TF32 control's mode
        print(f"f64 NLML {ll_ref!r}; f64 NLML of the f32 covariance {ll_rounded!r}")
        check_gates(f"accuracy modes N={N}", errors, MODE_TOLS)
        check_tf32_control(torch, f"accuracy mode both N={N}", both_errors,
                           {k: MODE_TOLS[k] for k in ("both", "both rounded")})
    finally:
        _set_modes(config, False, None)
    for name in modes:
        # only the plain mode's trailing updates run on the 3xTF32 kernel:
        # the compensated mode keeps the f32 GEMMs, the double-word loop its own
        trailing = PANELS - 1 if name == "plain" else 0
        if (counts[name]["radial_gram_diag"] != 1 or counts[name]["panel_cholinv"] != PANELS
                or counts[name]["trailing_update"] != trailing):
            fail(f"accuracy mode {name}: launches {counts[name]}")

    # the factorization's own error, below the f32 NLML's last digit: the
    # log-det and the quadratic term of the plain and the double-word loop,
    # each reduced in double word and read in f64, on the bench model's
    # covariance and on a dense, ill-conditioned one (SE with length scale
    # 5 and a 1e-2 nugget, the JAX package's test of the mode) at N_GRAD
    def loop_errors(what, K, rhs, ref):
        for name, factor in (("plain", blocked_cholesky_cols), ("double_word", blocked_cholesky_dw)):
            diag, white = factor(K, rhs=rhs, assemble=False)
            got = {"log-det": 2.0 * sum(t.item() for t in dw_sum(*accurate_log(diag))),
                   "quadratic": sum(t.item() for t in dw_sum(*two_prod(white, white)))}
            print(f"[{card}] {name} loop, {what}, against the f64 factor of the f32 matrix, relative: "
                  + ", ".join(f"{k} {abs(got[k] - ref[k]) / abs(ref[k]):.3e}" for k in got))

    loop_errors(f"bench model N={N} f32", cov + (0.0 if fused else JITTER) * torch.eye(N, device=cov.device),
                data.targets.mean, terms64)
    x_np, y_np = bench_data(np, N_GRAD, SEED + 2)
    xd, yd = torch.as_tensor(x_np, device="cuda"), torch.as_tensor(y_np, device="cuda")
    K = plain_radial_gram(xd, xd, 5.0, 1.0, PROFILE, torch.full((N_GRAD,), 1e-2, device="cuda"))
    L64 = torch.linalg.cholesky(K.double())
    white = torch.linalg.solve_triangular(L64, yd.double()[:, None], upper=False)[:, 0]
    loop_errors(f"SE(5) + 1e-2 I N={N_GRAD} f32", K, yd,
                {"log-det": 2.0 * torch.log(L64.diagonal()).sum().item(), "quadratic": (white @ white).item()})
    del K, L64, white

    # the accurate_log question: the f32 factor's diagonal, summed three ways
    d = CholeskyFactor.factorize(cov, jitter=0.0 if fused else JITTER, assume_symmetric=True).L.diagonal().clone()
    del cov
    exact = torch.log(d.double()).sum().item()
    logs = torch.log(d)
    ah, al = accurate_log(d)
    ulp = torch.finfo(torch.float32).eps * torch.log(d.double()).abs().clamp_min(1.0)
    signed = {"torch.log": (logs.double() - torch.log(d.double())) / ulp,
              "accurate_log": (ah.double() + al.double() - torch.log(d.double())) / ulp}
    ways = {"torch.log, f32 sum": logs.sum().item(),
            "torch.log, double-word sum": sum(t.item() for t in dw_sum(logs)),
            "accurate_log, double-word sum": sum(t.item() for t in dw_sum(ah, al))}
    print(f"[{card}] sum of logs of the f32 factor's {N} diagonal entries against f64 ({exact!r}), relative: "
          + ", ".join(f"{k} {abs(float(v) - exact) / abs(exact):.3e}" for k, v in ways.items()) + "; signed error "
          "a term: " + "; ".join(f"{k} mean {v.mean().item():+.4f} ulp, std {v.std().item():.4f}, max |.| "
                                 f"{v.abs().max().item():.4f}" for k, v in signed.items()))

    # value+grad under each mode at N_GRAD, with the value+grad phase's gates
    x_np, y_np = bench_data(np, N_GRAD, SEED + 2)
    data_g = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    x64 = torch.as_tensor(x_np, dtype=torch.float64, device="cuda")
    y64 = torch.as_tensor(y_np, dtype=torch.float64, device="cuda")
    ref = reference_value_grad(torch, model, x64, y64, PROFILE)
    try:
        for name in ("compensated", "double_word"):
            _set_modes(config, *modes[name])
            value, grad = value_grad(torch, model, data_g)
            errs = dict(zip(("value", "gradient"), grad_errors(value, grad, ref)))
            times = wall_times(torch, lambda: value_grad(torch, model, data_g), MODE_REPS)
            print(f"[{card}] value+grad N={N_GRAD} f32 {name}: {statistics.median(times) * 1e3:.2f} ms/eval "
                  f"(median of {MODE_REPS}; all {times})")
            check_gates(f"value+grad N={N_GRAD} {name}", errs, {"value": GRAD_VALUE_REL_TOL,
                                                                 "gradient": GRAD_REL_TOL})
    finally:
        _set_modes(config, False, None)
    print(f"[{card}] accuracy-modes phase: {time.perf_counter() - t0:.1f} s")
    return phase_counts


def unique_grid(np, n: int, seed: int):
    """n inputs on [0, 100], one a cell of a strict grid, jittered inside
    it: unique in f32 (benchmarks/exp_2d_bigN.py); targets as bench_data."""
    rng = np.random.default_rng(seed)
    x = ((np.arange(n) + rng.uniform(0.1, 0.9, n)) * (100.0 / n)).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    if len(np.unique(x)) != n:
        fail(f"the grid inputs repeat an f32 value at n={n}")
    return x, y


def _dist_errors(torch, multi: dict, single: dict) -> dict:
    return {k: (scalar_rel(multi[k], single[k]) if isinstance(multi[k], float) else max_rel(multi[k], single[k]))
            for k in multi}


def largest_allocation(torch):
    """A TorchDispatchMode that records the most entries any op writes
    into new memory (a view of an input, or an in-place result, is none)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Largest(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.largest = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            inputs = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor)}
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in inputs:
                    self.largest = max(self.largest, t.numel())
            return out

    return Largest()


def check_distributed_one(torch, np, pt, _build, card: str) -> dict:
    """The distributed GP on an NCCL world of one rank, in this process, at
    the main path's N: fit + predict of N_TEST points, log_likelihood and
    fast LOO against the single-process GaussianProcess on the same f32
    data on the card, in the 1-D row layout and in the 2-D tile layout on
    a (1, 1) mesh; then the distributed sparse GP on the same world
    (``check_sparse_one``).  Returns each phase's launch counts."""
    import tempfile

    import torch.distributed as dist

    from albatross_tpu_torch import parallel as par
    from albatross_tpu_torch.evaluation.cross_validation_utils import held_out_predictions
    from albatross_tpu_torch.indexing import LeaveOneOutGrouper, group_by
    from albatross_tpu_torch.models.gp import marginal_variance
    from albatross_tpu_torch.ops.linalg import ExplainedBySolve

    t0 = time.perf_counter()
    x_np, y_np = unique_grid(np, N, SEED)
    print(f"distributed phases: inputs on a jittered strict grid of [0, 100], unique in f32 (the bench draw "
          f"repeats f32 values; the sharded gram's noise compares features by value)")
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")
    kernel = bench_model(pt).covariance_function
    rendezvous = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}/init", world_size=1, rank=0)
    results, times, counts_by_layout, peaks = {}, {}, {}, {}
    try:
        mesh = par.make_mesh()
        mesh2d = par.make_mesh(axis_names=("data", "model"), shape=(1, 1))
        loo_idx = group_by(data, LeaveOneOutGrouper()).indexers()
        for name, model in (("single", pt.gp_from_covariance(kernel, jitter=JITTER)),
                            ("multi", par.distributed_gp_from_covariance(kernel, mesh, jitter=JITTER)),
                            ("2d", par.distributed_gp_from_covariance(kernel, mesh2d, col_axis="model",
                                                                      jitter=JITTER))):
            _build.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            ll = model.log_likelihood(data).item()
            times[f"{name} nlml first call"] = time.perf_counter() - t
            peaks[f"{name} nlml"] = torch.cuda.max_memory_allocated() / 2**30
            counts = dict(_build.LAUNCHES)
            nlml_counts = counts
            times[f"{name} nlml"] = statistics.median(wall_times(torch, lambda: model.log_likelihood(data), 2))
            _build.reset_launch_counts()
            _build.LAUNCHES.update(counts)  # the counted run: one NLML, one fit + predict
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            fit = model.fit(data)
            pred = fit.predict(xs).marginal()
            torch.cuda.synchronize()
            times[f"{name} fit + predict"] = time.perf_counter() - t
            peaks[f"{name} fit + predict"] = torch.cuda.max_memory_allocated() / 2**30
            counts = dict(_build.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            loo = held_out_predictions(fit.fit.train_covariance, data.targets.mean, fit.fit.information, loo_idx,
                                       pt.MarginalDistribution)
            torch.cuda.synchronize()
            times[f"{name} loo"] = time.perf_counter() - t
            peaks[f"{name} loo"] = torch.cuda.max_memory_allocated() / 2**30
            variance = pred.variance
            if name == "single":
                # the distributed factors solve twice for the variance (ExplainedBySolve); the single fit's own
                # variance takes the whitening kernel, held against f64 by check_whiten and the main path's gate,
                # so the comparison takes the single factor's two solves (no reference to the factor outlives
                # this line)
                variance = marginal_variance(model.covariance_function.diag(xs), ExplainedBySolve.explained_variance(
                    fit.fit.train_covariance, model._cross(fit.fit, xs)))
            results[name] = {"nlml": ll, "mean": pred.mean, "variance": variance,
                             "loo mean": loo.means[:, 0], "loo variance": loo.variances[:, 0]}
            print(f"[{card}] distributed world 1 (NCCL) N={N}, {name}: launches in one NLML {nlml_counts}, in "
                  f"it and one fit + predict {counts}")
            if name == "2d":
                tile = fit.fit.train_covariance.L.to_local()
                print(f"[{card}] distributed world 1 N={N}, 2d: the (1, 1) mesh's tile {tuple(tile.shape)}, "
                      f"{tile.numel() * tile.element_size() / 2**30:.2f} GiB")
                check_counts(f"distributed world 1 N={N} 2d log_likelihood", nlml_counts,
                             {"radial_gram": 1, "radial_gram_diag": 0, "radial_gram_cols": 0,
                              "panel_cholinv": PANELS})
                del tile
            counts_by_layout[name] = counts
            del fit, pred, loo
            torch.cuda.empty_cache()
        sparse_counts = check_sparse_one(torch, np, pt, _build, mesh, card)
    finally:
        dist.destroy_process_group()
    print(f"[{card}] distributed world 1 N={N} f32 seconds: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    print(f"[{card}] distributed world 1 N={N} f32 peak device memory GiB: "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items()))
    check_gates(f"distributed world 1 N={N} against the single-process GP", _dist_errors(torch, results["multi"],
                                                                                        results["single"]),
                DIST_ONE_TOLS)
    check_gates(f"distributed world 1 N={N}, 2-D layout on a (1, 1) mesh, against the single-process GP",
                _dist_errors(torch, results["2d"], results["single"]), DIST_2D_ONE_TOLS)
    multi_counts = counts_by_layout["multi"]
    if multi_counts["panel_cholinv"] != 2 * PANELS or multi_counts["radial_gram"] < 3:
        fail(f"distributed world 1: launches {multi_counts}")
    check_counts(f"distributed world 1 N={N} 2d NLML + fit + predict", counts_by_layout["2d"],
                 {"radial_gram": 3, "radial_gram_diag": 0, "radial_gram_cols": 0, "panel_cholinv": 2 * PANELS})
    print(f"[{card}] distributed world-1 phase: {time.perf_counter() - t0:.1f} s")
    return {"distributed_one": multi_counts, "distributed_one_2d": counts_by_layout["2d"],
            "distributed_sparse_one": sparse_counts}


def check_sparse_one(torch, np, pt, _build, mesh, card: str) -> dict:
    """The distributed sparse GP (FITC) at FITC's cell on the NCCL world of
    one: fit + predict of N_TEST marginals and log_likelihood against the
    single-process FITC on the same f32 data on the card; |diag R| of the
    TSQR of the f32 data's B against the TSQR of the f64 data's.  Returns
    the distributed run's launch counts."""
    from albatross_tpu_torch import parallel as par

    x_np, y_np = bench_data(np, N_FITC, SEED + 4)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")
    single = sparse_model(pt, FITC_LS, pt.UniformlySpacedInducingPoints(M_FITC))
    multi = par.distributed_sparse_gp_from_covariance(single.covariance_function, mesh,
                                                      inducing_point_strategy=pt.UniformlySpacedInducingPoints(M_FITC))
    out, times, counts = {}, {}, {}
    for name, model in (("single", single), ("multi", multi)):
        _build.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        pred = model.fit(data).predict(xs).marginal()
        torch.cuda.synchronize()
        times[f"{name} fit + predict"] = time.perf_counter() - t
        ll = model.log_likelihood(data).item()
        counts[name] = dict(_build.LAUNCHES)
        times[f"{name} peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
        times[f"{name} nlml"] = statistics.median(wall_times(torch, lambda: model.log_likelihood(data), 2))
        out[name] = {"mean": pred.mean, "variance": pred.variance, "nlml": ll}
        del pred
    print(f"[{card}] distributed sparse FITC world 1 (NCCL) N={N_FITC} M={M_FITC} f32: launches in fit + predict "
          f"+ log_likelihood {counts['multi']} (single process {counts['single']}); seconds and peaks: "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    check_gates(f"distributed sparse FITC world 1 N={N_FITC} against the single-process FITC",
                _dist_errors(torch, out["multi"], out["single"]), DIST_SPARSE_ONE_TOLS)
    if counts["multi"]["radial_gram"] == 0 or counts["multi"]["panel_cholinv"] == 0:
        fail(f"distributed sparse FITC world 1: no gram or panel kernel launched: {counts['multi']}")

    def whitened(d):
        u = single.inducing_point_strategy(single.covariance_function, d.features)
        A_chol, K_uu_chol, K_fu, _ = single._compute_internal_components(u, d.features, d.targets)
        return A_chol.sqrt_solve(K_fu), K_uu_chol.L.T

    with torch.no_grad():
        B, tail = whitened(data)
        diag32 = par.distributed_tall_qr(B, mesh, extra=tail).diagonal()
        del B, tail
        data64 = pt.RegressionDataset.create(x_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)
        B, tail = whitened(data64)
        diag64 = par.distributed_tall_qr(B, mesh, extra=tail).diagonal()
        del B, tail
    print(f"distributed sparse FITC N={N_FITC}: |diag R| of the TSQR (both QRs in f64) of the f32 data's B against "
          f"the TSQR of the f64 data's: {max_rel(diag32, diag64):.3e}")
    torch.cuda.empty_cache()
    return counts["multi"]


def _dist_run(torch, np, pt, _build, mesh) -> dict:
    """One rank's (or the single process's, with ``mesh`` None) run of the
    gloo phase: NLML, fit + predict, LOO, LOGO, value+grad, the sampler;
    values on the host, seconds and launch counts."""
    from albatross_tpu_torch import parallel as par
    from albatross_tpu_torch.evaluation.cross_validation_utils import held_out_predictions
    from albatross_tpu_torch.indexing import LeaveOneOutGrouper, group_by
    from albatross_tpu_torch.samplers import ensemble_sampler_from_model

    x_np, y_np = unique_grid(np, N_DIST, SEED + 5)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")
    kernel = bench_model(pt).covariance_function
    model = (pt.gp_from_covariance(kernel, jitter=JITTER) if mesh is None
             else par.distributed_gp_from_covariance(kernel, mesh, jitter=JITTER))
    out, seconds = {}, {}
    _build.reset_launch_counts()

    def timed(name, fn):
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return value

    out["nlml"] = timed("nlml first call", lambda: model.log_likelihood(data).item())
    timed("nlml", lambda: model.log_likelihood(data).item())
    fit = timed("fit + predict", lambda: model.fit(data))
    pred = fit.predict(xs).marginal()
    out["mean"], out["variance"] = pred.mean.cpu(), pred.variance.cpu()
    loo = timed("loo", lambda: held_out_predictions(fit.fit.train_covariance, data.targets.mean, fit.fit.information,
                                                    group_by(data, LeaveOneOutGrouper()).indexers(),
                                                    pt.MarginalDistribution))
    out["loo mean"], out["loo variance"] = loo.means[:, 0].cpu(), loo.variances[:, 0].cpu()
    groups = {g: np.arange(g * CV_GROUP, (g + 1) * CV_GROUP) for g in range(N_DIST // CV_GROUP)}
    from albatross_tpu_torch.indexing.grouping import Grouped

    logo = timed("logo", lambda: held_out_predictions(fit.fit.train_covariance, data.targets.mean,
                                                      fit.fit.information, Grouped(groups), pt.JointDistribution))
    # one batched form on the single process, one JointDistribution a group from the distributed factor
    out["logo mean"] = torch.stack([logo[g].mean for g in groups]).cpu()
    out["logo covariance"] = torch.stack([logo[g].covariance for g in groups]).cpu()
    value, grad = timed("value+grad", lambda: value_grad(torch, model, data))
    out["value"], out["gradient"] = value.item(), grad.cpu()
    chain = timed("sampler", lambda: ensemble_sampler_from_model(
        pt.gp_from_covariance(kernel, jitter=JITTER), data, DIST_WALKERS, DIST_ITERATIONS, key=SEED,
        **({} if mesh is None else {"mesh": mesh, "mesh_axis": "data"})))
    out["sampler"] = torch.as_tensor(chain.log_prob)
    return {"out": out, "seconds": seconds, "launches": dict(_build.LAUNCHES)}


def _dist_run_2d(torch, np, pt, _build, mesh2d) -> dict:
    """One rank's (or the single process's, with ``mesh2d`` None) run of
    the 2-D layout on the gloo world: NLML, fit + predict, LOO, LOGO, an
    update and value+grad on the data of ``_dist_run``; values on the
    host, seconds, launch counts, the largest tensor an op of the forward
    calls wrote, the tile's bytes and the peak device memory."""
    from albatross_tpu_torch import parallel as par
    from albatross_tpu_torch.evaluation.cross_validation_utils import held_out_predictions
    from albatross_tpu_torch.indexing import LeaveOneOutGrouper, group_by
    from albatross_tpu_torch.indexing.grouping import Grouped

    x_np, y_np = unique_grid(np, N_DIST, SEED + 5)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    first = pt.RegressionDataset.create(x_np[:DIST_UPDATE_FIRST], y_np[:DIST_UPDATE_FIRST], dtype=torch.float32)
    rest = pt.RegressionDataset.create(x_np[DIST_UPDATE_FIRST:], y_np[DIST_UPDATE_FIRST:], dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")
    kernel = bench_model(pt).covariance_function
    model = (pt.gp_from_covariance(kernel, jitter=JITTER) if mesh2d is None
             else par.distributed_gp_from_covariance(kernel, mesh2d, col_axis="model", jitter=JITTER))
    groups = {g: np.arange(g * CV_GROUP, (g + 1) * CV_GROUP) for g in range(N_DIST // CV_GROUP)}
    out, seconds = {}, {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()

    def timed(name, fn):
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        return value

    recorder = largest_allocation(torch)
    with recorder if mesh2d is not None else contextlib.nullcontext():  # the counted run's forward ops
        out["nlml"] = timed("nlml first call", lambda: model.log_likelihood(data).item())
        fit = timed("fit + predict", lambda: model.fit(data))
        pred = fit.predict(xs).marginal()
        out["mean"], out["variance"] = pred.mean.cpu(), pred.variance.cpu()
        loo = timed("loo", lambda: held_out_predictions(fit.fit.train_covariance, data.targets.mean,
                                                        fit.fit.information,
                                                        group_by(data, LeaveOneOutGrouper()).indexers(),
                                                        pt.MarginalDistribution))
        out["loo mean"], out["loo variance"] = loo.means[:, 0].cpu(), loo.variances[:, 0].cpu()
        logo = timed("logo", lambda: held_out_predictions(fit.fit.train_covariance, data.targets.mean,
                                                          fit.fit.information, Grouped(groups),
                                                          pt.JointDistribution))
        out["logo mean"] = torch.stack([logo[g].mean for g in groups]).cpu()
        out["logo covariance"] = torch.stack([logo[g].covariance for g in groups]).cpu()
        updated = timed("update", lambda: model.fit(first).update(rest))
        up = updated.predict(xs).marginal()
        out["update mean"], out["update variance"] = up.mean.cpu(), up.variance.cpu()
    value, grad = timed("value+grad", lambda: value_grad(torch, model, data))
    out["value"], out["gradient"] = value.item(), grad.cpu()
    timed("nlml", lambda: model.log_likelihood(data).item())
    tile = fit.fit.train_covariance.L.to_local() if mesh2d is not None else fit.fit.train_covariance.L
    return {"out": out, "seconds": seconds, "launches": dict(_build.LAUNCHES), "largest": recorder.largest,
            "tile": (tuple(tile.shape), tile.numel() * tile.element_size()),
            "peak": torch.cuda.max_memory_allocated()}


def _dist_run_sparse(torch, np, pt, _build, mesh) -> dict:
    """One rank's (or the single process's, with ``mesh`` None) run of the
    distributed sparse GP on the gloo world: FITC and PITC (groups by
    floor(x / PITC_WIDTH), which straddle the ranks' rows) at PITC's cell,
    fit + predict, log_likelihood and value+grad."""
    from albatross_tpu_torch import parallel as par

    x_np, y_np = bench_data(np, N_PITC, SEED + 5)
    data = pt.RegressionDataset.create(x_np, y_np, dtype=torch.float32)
    xs = torch.linspace(0.0, 100.0, N_TEST, device="cuda")

    def grouper(features):
        return np.floor(features.cpu().numpy() / PITC_WIDTH).astype(np.int64)

    out, seconds = {}, {}
    _build.reset_launch_counts()
    for name, group in (("fitc", None), ("pitc", grouper)):
        single = sparse_model(pt, PITC_LS, pt.UniformlySpacedInducingPoints(M_PITC), group)
        model = single if mesh is None else par.distributed_sparse_gp_from_covariance(
            single.covariance_function, mesh, grouper=single.grouper,
            inducing_point_strategy=single.inducing_point_strategy)
        t = time.perf_counter()
        pred = model.fit(data).predict(xs).marginal()
        torch.cuda.synchronize()
        seconds[f"{name} fit + predict"] = time.perf_counter() - t
        out[f"{name} mean"], out[f"{name} variance"] = pred.mean.cpu(), pred.variance.cpu()
        t = time.perf_counter()
        out[f"{name} nlml"] = model.log_likelihood(data).item()
        seconds[f"{name} nlml"] = time.perf_counter() - t
        value, grad = value_grad(torch, model, data)
        out[f"{name} value"], out[f"{name} gradient"] = value.item(), grad.cpu()
    sizes = np.unique(grouper(torch.as_tensor(x_np)), return_counts=True)[1]
    bounds = np.cumsum(sizes)[:-1]
    b = N_PITC // DIST_WORLD
    straddling = int(np.sum((bounds // b) != ((bounds - sizes[:-1]) // b)))
    return {"out": out, "seconds": seconds, "launches": dict(_build.LAUNCHES),
            "groups": (len(sizes), straddling)}


def _dist_rank(rank: int, world: int, rendezvous: str, root: str) -> None:
    """A rank of the gloo world on the shared card: runs ``_dist_run`` and
    writes its result, or its traceback, to ``rank<r>.pkl``."""
    import pickle
    import traceback

    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.distributed as dist

    import albatross_tpu_torch as pt
    from albatross_tpu_torch import _build
    from albatross_tpu_torch import parallel as par

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}/init", world_size=world, rank=rank)
    try:
        mesh = par.make_mesh()
        result = {"ok": True, **_dist_run(torch, np, pt, _build, mesh)}
        # the same ranks: the 2-D layout on a second mesh, then the sparse GP
        result["2d"] = _dist_run_2d(torch, np, pt, _build,
                                    par.make_mesh(axis_names=("data", "model"), shape=DIST_2D_SHAPE))
        result["sparse"] = _dist_run_sparse(torch, np, pt, _build, mesh)
    except Exception:  # the parent fails with it
        result = {"ok": False, "error": traceback.format_exc()}
    with open(f"{rendezvous}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def check_distributed_four(torch, np, pt, _build, card: str) -> dict:
    """The distributed GP on a gloo world of DIST_WORLD processes sharing
    the card at N_DIST: NLML, fit + predict, LOO, a LOGO of 128 groups of
    64, value+grad and the walker-sharded sampler, each against the
    single-process run on the card.  The collectives are staged through
    the host (gloo), so the times are not a multi-GPU time.  Returns the
    ranks' summed launch counts."""
    import multiprocessing
    import pickle
    import tempfile

    t0 = time.perf_counter()
    ref = _dist_run(torch, np, pt, _build, None)
    ref2d = _dist_run_2d(torch, np, pt, _build, None)
    ref_sparse = _dist_run_sparse(torch, np, pt, _build, None)
    # the ranks share the card with this process: hand its cached blocks back before they allocate
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{card}] gloo world: this process holds {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved, as the ranks start")
    rendezvous = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_dist_rank, args=(r, DIST_WORLD, rendezvous, str(Path(__file__).resolve().parent)))
             for r in range(DIST_WORLD)]
    for p in procs:
        p.start()
    deadline = time.perf_counter() + DIST_TIMEOUT
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.perf_counter()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        fail(f"gloo world: ranks {hung} still running after {DIST_TIMEOUT} s")
    ranks = []
    for r in range(DIST_WORLD):
        path = Path(rendezvous) / f"rank{r}.pkl"
        if not path.exists():
            fail(f"gloo world: rank {r} wrote no result (exit code {procs[r].exitcode})")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if not res["ok"]:
            fail(f"gloo world: rank {r} failed:\n{res['error']}")
        ranks.append(res)
    for r in ranks[1:]:
        for k, v in r["out"].items():
            same = v == ranks[0]["out"][k] if isinstance(v, float) else torch.equal(v, ranks[0]["out"][k])
            if not same:
                fail(f"gloo world: rank results differ in {k}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"[{card}] distributed world {DIST_WORLD} (gloo, {DIST_WORLD} processes sharing the card) N={N_DIST}: "
          f"launches summed over the ranks {launches}; single process {ref['launches']}")
    print(f"[{card}] distributed world {DIST_WORLD} N={N_DIST} f32 seconds (collectives staged through the host "
          f"by gloo, not a multi-GPU time): rank 0 " + ", ".join(f"{k} {v:.4f}" for k, v in ranks[0]["seconds"].items())
          + "; single process " + ", ".join(f"{k} {v:.4f}" for k, v in ref["seconds"].items()))
    out = dict(ranks[0]["out"])
    out["sampler"] = out["sampler"].double()
    refs = dict(ref["out"])
    refs["sampler"] = refs["sampler"].double()
    check_gates(f"distributed world {DIST_WORLD} N={N_DIST} against the single-process run",
                _dist_errors(torch, out, refs), DIST_FOUR_TOLS)
    if launches["panel_cholinv"] == 0 or launches["radial_gram"] == 0:
        fail(f"gloo world: the ranks launched no panel or gram kernel: {launches}")
    for r in ranks[1:]:
        for part in ("2d", "sparse"):
            for k, v in r[part]["out"].items():
                same = v == ranks[0][part]["out"][k] if isinstance(v, float) else torch.equal(v, ranks[0][part]["out"][k])
                if not same:
                    fail(f"gloo world: rank results differ in {part} {k}")

    # the 2-D layout on a DIST_2D_SHAPE mesh of the same ranks
    launches_2d = {k: sum(r["2d"]["launches"][k] for r in ranks) for k in ranks[0]["2d"]["launches"]}
    steps = N_DIST // COL_B  # panel steps a factorization: the tile width N / C is a multiple of 1024
    print(f"[{card}] distributed world {DIST_WORLD} N={N_DIST}, 2-D layout on a {DIST_2D_SHAPE} mesh: launches "
          f"summed over the ranks {launches_2d} (each rank: {ranks[0]['2d']['launches']}); single process "
          f"{ref2d['launches']}")
    print(f"[{card}] distributed world {DIST_WORLD} N={N_DIST} 2-D f32 seconds (gloo, through the host): rank 0 "
          + ", ".join(f"{k} {v:.4f}" for k, v in ranks[0]["2d"]["seconds"].items()) + "; single process "
          + ", ".join(f"{k} {v:.4f}" for k, v in ref2d["seconds"].items()))
    for r, res in enumerate(ranks):
        shape, nbytes = res["2d"]["tile"]
        print(f"[{card}] gloo rank {r}: 2-D factor tile {shape}, {nbytes / 2**20:.1f} MiB; largest tensor a "
              f"forward op wrote {res['2d']['largest']} entries (N^2 = {N_DIST * N_DIST}); peak device memory "
              f"{res['2d']['peak'] / 2**30:.2f} GiB (single process {ref2d['peak'] / 2**30:.2f} GiB)")
        if res["2d"]["largest"] >= N_DIST * N_DIST:
            fail(f"gloo rank {r} wrote an N x N tensor in the 2-D layout ({res['2d']['largest']} entries)")
    check_gates(f"distributed world {DIST_WORLD} N={N_DIST}, 2-D layout, against the single-process run",
                _dist_errors(torch, ranks[0]["2d"]["out"], ref2d["out"]), DIST_2D_FOUR_TOLS)
    # every rank launches the panel kernel once a panel step of each
    # factorization: two NLMLs, the fit, value+grad's forward, and the
    # update's fit of the first DIST_UPDATE_FIRST points
    expected = 4 * steps + DIST_UPDATE_FIRST // COL_B
    if any(r["2d"]["launches"]["panel_cholinv"] != expected for r in ranks) or launches_2d["radial_gram"] == 0:
        fail(f"gloo world 2-D layout: launches {[r['2d']['launches'] for r in ranks]}")

    # the distributed sparse GP on the 1-D mesh of the same ranks
    launches_sparse = {k: sum(r["sparse"]["launches"][k] for r in ranks) for k in ranks[0]["sparse"]["launches"]}
    n_groups, straddling = ranks[0]["sparse"]["groups"]
    print(f"[{card}] distributed sparse world {DIST_WORLD} N={N_PITC} M={M_PITC}: PITC {n_groups} groups, "
          f"{straddling} straddle the ranks' rows; launches summed over the ranks {launches_sparse}; single "
          f"process {ref_sparse['launches']}")
    print(f"[{card}] distributed sparse world {DIST_WORLD} f32 seconds (gloo, through the host): rank 0 "
          + ", ".join(f"{k} {v:.4f}" for k, v in ranks[0]["sparse"]["seconds"].items()) + "; single process "
          + ", ".join(f"{k} {v:.4f}" for k, v in ref_sparse["seconds"].items()))
    check_gates(f"distributed sparse world {DIST_WORLD} N={N_PITC} against the single-process FITC and PITC",
                _dist_errors(torch, ranks[0]["sparse"]["out"], ref_sparse["out"]), DIST_SPARSE_FOUR_TOLS)
    if straddling == 0 or launches_sparse["radial_gram"] == 0:
        fail(f"distributed sparse world: {straddling} straddling groups, launches {launches_sparse}")
    print(f"[{card}] distributed world-{DIST_WORLD} phase: {time.perf_counter() - t0:.1f} s")
    return {"distributed_four": launches, "distributed_four_2d": launches_2d, "distributed_sparse_four": launches_sparse}


NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?")


def _leaves(value, path: str = ""):
    """(path, leaf) pairs of a run()'s result: numbers, arrays and texts."""
    if isinstance(value, dict):
        for key, v in value.items():
            yield from _leaves(v, f"{path}.{key}")
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, value


def _last_digit(text: str) -> float:
    mantissa, _, exponent = text.lower().partition("e")
    return 10.0 ** (-len(mantissa.partition(".")[2]) + (int(exponent) if exponent else 0))


def _printed_close(x: str, y: str) -> bool:
    """Two printed numbers equal in magnitude to one unit of the last
    printed digit (an eigenvector's sign is arbitrary), or both below
    EX_CPU_FLOOR (rounding residues)."""
    a, b = abs(float(x)), abs(float(y))
    return abs(a - b) <= max(_last_digit(x), _last_digit(y)) * 1.000001 or max(a, b) <= EX_CPU_FLOOR


def cpu_mismatches(np, card: dict, cpu: dict) -> tuple[list, float]:
    """(the leaves where the card's run() differs from the CPU's, the
    largest relative difference of a number above EX_CPU_FLOOR): numbers
    within EX_CPU_RTOL relative or EX_CPU_FLOOR absolute; texts equal but
    for their numbers (``_printed_close``)."""
    bad, largest = [], 0.0
    card_leaves, cpu_leaves = list(_leaves(card)), list(_leaves(cpu))
    if [p for p, _ in card_leaves] != [p for p, _ in cpu_leaves]:
        return ["the results' structure"], math.nan
    for (path, a), (_, b) in zip(card_leaves, cpu_leaves):
        if isinstance(a, str):
            words_equal = NUMBER.sub("#", a) == NUMBER.sub("#", b)
            if not (words_equal and all(_printed_close(x, y) for x, y in zip(NUMBER.findall(a), NUMBER.findall(b)))):
                bad.append(path)
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        diff = np.abs(a - b)
        scale = np.maximum(np.abs(a), np.abs(b))
        if a.shape != b.shape or not np.all(diff <= EX_CPU_RTOL * scale + EX_CPU_FLOOR):
            bad.append(path)
        above = scale > EX_CPU_FLOOR
        if a.shape == b.shape and above.any():
            largest = max(largest, float(np.max(diff[above] / scale[above])))
    return bad, largest


def timed_run(torch, _build, fn) -> tuple:
    """(fn's result, its synchronised seconds, the kernel launches it made:
    the counts set to 0 just before and read just after)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, dict(_build.LAUNCHES)


def report_example(name: str, card: str, seconds: float, ref_seconds: float, errors: dict, launches: dict,
                   f32_n: int = 0) -> None:
    """Print an example's seconds, errors against its reference (beside
    its gates) and launches; fail on a gate, or when an f32 run above
    n = 2048 launched no panel kernel."""
    print(f"[{card}] example {name}: {seconds:.3f} s, reference {ref_seconds:.3f} s; launches {launches}")
    check_gates(f"[{card}] example {name}", errors, EX_TOLS[name])
    if f32_n > 2048 and launches["panel_cholinv"] + launches["panel_cholinv_batched"] == 0:
        fail(f"example {name}: an f32 run at n = {f32_n} launched no panel kernel")


def check_examples(torch, np, _build, card: str) -> dict:
    """Phase (h): the port's examples and tutorials at full size through
    their run(), each against its reference (see EX_TOLS).  Returns each
    run's kernel launches by name."""
    import tempfile

    from albatross_tpu_torch.evaluation import LeaveOneOutLikelihood
    from albatross_tpu_torch.examples import accuracy, distributed, sampler, sinc, sparse

    f32, f64 = torch.float32, torch.float64
    t_phase = time.perf_counter()
    counts = {}

    # sinc's radial_only model at EX_SINC_N, and its f32 NLML where it no longer factors
    out32, secs, counts["sinc_radial_only"] = timed_run(
        torch, _build, lambda: sinc.run("radial_only", n=EX_SINC_N, device="cuda", dtype=f32))
    out64, ref_secs, _ = timed_run(
        torch, _build, lambda: sinc.run("radial_only", n=EX_SINC_N, device="cuda", dtype=f64))
    report_example("sinc_radial_only", card, secs, ref_secs, {
        "nlml": scalar_rel(out32["nlml"], out64["nlml"]), "rmse": scalar_rel(out32["rmse"], out64["rmse"]),
        "mean": max_rel(torch.as_tensor(out32["mean"]), torch.as_tensor(out64["mean"])),
        "variance": max_rel(torch.as_tensor(out32["variance"]), torch.as_tensor(out64["variance"]))},
        counts["sinc_radial_only"], EX_SINC_N)
    for mode, sizes in (("radial_only", EX_SINC_NAN_N), ("radial", EX_RADIAL_N)):
        for n in sizes:
            nlml = [float(-sinc.build_model(mode).log_likelihood(sinc.make_data(n, 1.0, device="cuda", dtype=dt)))
                    for dt in (f32, f64)]
            print(f"[{card}] example sinc {mode} at n = {n}: NLML f32 {nlml[0]!r}, f64 {nlml[1]!r}, relative "
                  f"{scalar_rel(*nlml):.3e} (where the f32 factor fails, not gated)")

    # the parametric sinc model tuned by L-BFGS on the LOO likelihood
    out32, secs, counts["sinc_parametric_tuned"] = timed_run(
        torch, _build, lambda: sinc.run("parametric", tune=True, n=EX_TUNE_N, device="cuda", dtype=f32))
    out64, ref_secs, _ = timed_run(
        torch, _build, lambda: sinc.run("parametric", tune=True, n=EX_TUNE_N, device="cuda", dtype=f64))
    at_f32_optimum = float(LeaveOneOutLikelihood()(sinc.make_data(EX_TUNE_N, 1.0, device="cuda", dtype=f64),
                                                   sinc.build_model("parametric").set_param_values(out32["params"])))
    print(f"[{card}] example sinc_parametric_tuned: tuned LOO objective f32 {out32['tuned_objective']!r}, f64 at "
          f"the f32 optimum {at_f32_optimum!r}, f64 tuned {out64['tuned_objective']!r}")
    report_example("sinc_parametric_tuned", card, secs, ref_secs, {
        "objective at the f32 optimum": scalar_rel(out32["tuned_objective"], at_f32_optimum),
        "tuned objective": scalar_rel(out32["tuned_objective"], out64["tuned_objective"])},
        counts["sinc_parametric_tuned"], EX_TUNE_N)

    # the sparse example: FITC with EX_M inducing points, and the exact GP
    out32, secs, counts["sparse"] = timed_run(
        torch, _build, lambda: sparse.run(EX_SPARSE_N, EX_M, device="cuda", dtype=f32))
    out64, ref_secs, _ = timed_run(torch, _build, lambda: sparse.run(EX_SPARSE_N, EX_M, device="cuda", dtype=f64))
    print(f"[{card}] example sparse: max |sparse - exact| mean f32 {out32['max_err']!r}, f64 {out64['max_err']!r}")
    for m in EX_M_NAN:
        nlml = sparse.run(EX_SPARSE_N, m, device="cuda", dtype=f32)["nlml"]
        print(f"[{card}] example sparse at M = {m}: NLML f32 {nlml!r} (where K_uu's f32 factor fails, not gated)")
    report_example("sparse", card, secs, ref_secs, {
        "sparse mean": max_rel(torch.as_tensor(out32["sparse_mean"]), torch.as_tensor(out64["sparse_mean"])),
        "sparse variance": max_rel(torch.as_tensor(out32["sparse_variance"]),
                                   torch.as_tensor(out64["sparse_variance"])),
        "exact mean": max_rel(torch.as_tensor(out32["exact_mean"]), torch.as_tensor(out64["exact_mean"])),
        "nlml": scalar_rel(out32["nlml"], out64["nlml"])}, counts["sparse"], EX_SPARSE_N)

    # the sampler example: the warm start against f64, then the chain
    with tempfile.TemporaryDirectory() as tmp:
        out32, secs, counts["sampler"] = timed_run(torch, _build, lambda: sampler.run(
            N_SAMPLER, W_SAMPLER, SAMPLER_ITERATIONS, EX_BURN_IN, f"{tmp}/chains.csv", device="cuda", dtype=f32))
        with open(f"{tmp}/chains.csv") as f:
            rows = sum(1 for _ in f)
    (_, ref), ref_secs, _ = timed_run(torch, _build, lambda: sampler.tune(
        sampler.make_data(N_SAMPLER, device="cuda", dtype=f64)))
    print(f"[{card}] example sampler: acceptance {out32['acceptance_rate']!r}, posterior length scale "
          f"{out32['length_scale']}, sigma {out32['sigma']}, {rows} CSV rows, {W_SAMPLER * SAMPLER_ITERATIONS} "
          f"walker-steps in {secs:.3f} s (the warm start included)")
    if not (np.isfinite(out32["log_prob"]).all() and 0.0 < out32["acceptance_rate"] < 1.0
            and rows == 1 + (SAMPLER_ITERATIONS + 1) * W_SAMPLER):
        fail(f"example sampler: a non-finite log-prob, acceptance {out32['acceptance_rate']} or {rows} CSV rows")
    report_example("sampler", card, secs, ref_secs, {"tuned nlml": scalar_rel(out32["tuned_nlml"], float(ref.value))},
                   counts["sampler"], N_SAMPLER)

    # the accuracy example: its own f32 data against its own f64 oracle on the card
    out, secs, counts["accuracy"] = timed_run(torch, _build, lambda: accuracy.run(EX_N, device="cuda"))
    print(f"[{card}] example accuracy: f64 oracle log-likelihood {out['oracle']!r}; "
          + "; ".join(f"{k} {ll!r}" for k, (ll, _) in out["modes"].items()))
    report_example("accuracy", card, secs, secs, {k: rel for k, (_, rel) in out["modes"].items()},
                   counts["accuracy"], EX_N)

    # the distributed example on its own (4, 2) mesh of gloo ranks sharing the card
    t = time.perf_counter()
    out = distributed.run(N_DIST, EX_RANKS, device="cuda")
    counts["distributed"] = out["launches"]
    print(f"[{card}] example distributed: {time.perf_counter() - t:.3f} s on {EX_RANKS} gloo ranks, N = {N_DIST}, "
          f"f64; NLML single {out['single_nlml']!r}, 1-D {out['nlml_1d']!r}, 2-D {out['nlml_2d']!r}; sparse "
          f"{out['sparse_ll']!r} (single {out['sparse_single_ll']!r}); max|dmean| 1-D {out['mean_err_1d']:.3e}, "
          f"2-D {out['mean_err_2d']:.3e}, update {out['update_err']:.3e}, sparse {out['sparse_mean_err']:.3e}; "
          f"tiles {out['tiles']}; launches (summed over ranks) {out['launches']}")
    if not (out["ok"] and out["tiles"] == [(N_DIST // 4, N_DIST // 2)] * EX_RANKS):
        fail(f"example distributed: its single-process checks failed or its tiles are {out['tiles']}")

    # inspection and the tutorials as written: f64 on the card against the CPU
    for module in EX_SMALL:
        run = importlib.import_module(f"albatross_tpu_torch.{module}").run
        card_out, secs, counts[module] = timed_run(torch, _build, lambda: run("cuda"))
        t = time.perf_counter()
        cpu_out = run("cpu")
        bad, largest = cpu_mismatches(np, card_out, cpu_out)
        print(f"[{card}] {module}: {secs:.3f} s on the card, {time.perf_counter() - t:.3f} s on the CPU; card "
              f"against CPU largest relative difference {largest:.3e} (tol {EX_CPU_RTOL:g}, floor "
              f"{EX_CPU_FLOOR:g}); launches {counts[module]}")
        if bad:
            fail(f"{module} on the card differs from the CPU at {bad}")
    print(f"[{card}] phase (h), the examples and tutorials: {time.perf_counter() - t_phase:.1f} s")
    return {f"example_{name.replace('.', '_')}": c for name, c in counts.items()}


def highd_data(np, n: int, m: int, d: int = HD_D):
    """Phase (i)'s data: (X (n, d), y (n,), Xs (m, d)), f32, Xs of the same
    law (the same line u, its own t and xi)."""
    rng = np.random.default_rng(HD_SEED)
    t = np.sort(rng.uniform(0.0, 100.0, n))
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    X = (1000.0 + t[:, None] * u[None, :] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    y = (np.sin(0.3 * t) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    ts = np.sort(rng.uniform(0.0, 100.0, m))
    Xs = (1000.0 + ts[:, None] * u[None, :] + 0.05 * rng.standard_normal((m, d))).astype(np.float32)
    return X, y, Xs


def highd_model(pt):
    kernel = pt.SquaredExponential(HD_LENGTH_SCALE, SIGMA) + pt.measurement_only(
        pt.IndependentNoise(NOISE, assume_unique=True))
    return pt.gp_from_covariance(kernel, jitter=JITTER)


def highd_bound(n: int, m: int, d: int, square: bool, diag: bool) -> tuple[float, str]:
    """Bound of an (n, m) radial gram at D = d for any implementation: the
    bytes (inputs read once, the output written once) over the memory rate,
    or the 2 d n m contraction at the dense TF32 rate plus PROFILE_OPS FP32
    operations an element, whichever is larger."""
    nbytes = 4 * (n * m + n * d + (0 if square else m * d) + (n if diag else 0))
    by_bytes = nbytes / HBM_BYTES_PER_S
    by_ops = 2 * d * n * m / TF32_FLOP_PER_S + PROFILE_OPS * n * m / FP32_FLOP_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def highd_tiles(n: int, m: int, square: bool) -> int:
    """128 x 128 tiles the high-D kernel computes for an (n, m) gram: every
    tile of the cross form, the lower tiles of K(x, x) (each written
    twice)."""
    nt, mt = -(-n // 128), -(-m // 128)
    return nt * (nt + 1) // 2 if square else nt * mt


def tile_rate(r: dict, tiles: int) -> None:
    """A kernel row's tile count and its nanoseconds a tile across the card."""
    r["tiles"], r["ns_per_tile"] = tiles, r["ms"] * 1e6 / tiles
    print(f"  {tiles} tiles: {r['ns_per_tile']:.1f} ns a tile across the card")


def loop_gram(torch, _build, X, Y, ls: float, sigma: float, profile: str, diag=None):
    """The kernel's elementwise loop at any D through its f32 C entry
    (``radial_gram_f32``), which the wrapper calls only below D = 8: the
    design before the high-D branch, timed beside it.  Not counted."""
    import ctypes

    from albatross_tpu_torch.ops.radial_gram import PROFILES

    lib = _build.load("radial_gram")
    out = torch.empty((X.shape[0], Y.shape[0]), dtype=torch.float32, device=X.device)
    fn = lib.radial_gram_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    code = fn(X.data_ptr(), Y.data_ptr(), None if diag is None else diag.data_ptr(), out.data_ptr(), X.shape[0],
              Y.shape[0], X.shape[1], ls, sigma, PROFILES.index(profile), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        fail(f"the elementwise loop's launch: CUDA error {code}")
    return out


def highd_sweep(torch, np, _build, card: str) -> list:
    """The high-D branch at D = HD_SWEEP_D on two data kinds, the cross
    covariance (N, N_TEST) and the training covariance N^2 + diag, SE with
    sigma 1: its milliseconds and the elementwise loop's (``loop_gram``, the
    design before the branch) on the same inputs in turns (loop, branch,
    branch, loop); the share of tiles the TPU kernel's rule refines
    (``tiled_squared_distances``); the largest |branch - loop|; the bound.
    Kinds: ``bench``, bench.py's high-D data (U[0, 100]^D, length scale 10:
    only the covariance's diagonal tiles refine); ``slice``, phase (i)'s law
    at D (length scale 2: a band of near tiles refines)."""
    from albatross_tpu_torch.ops.radial_gram import radial_gram, tiled_squared_distances

    dev = torch.device("cuda")
    rows = []
    diag = torch.full((N,), NOISE * NOISE + JITTER, dtype=torch.float32, device=dev)
    for kind in ("bench", "slice"):
        for d in HD_SWEEP_D:
            if kind == "bench":
                rng = np.random.default_rng(d)
                xn = rng.uniform(0.0, 100.0, (N, d)).astype(np.float32)
                yn, ls = rng.uniform(0.0, 100.0, (N_TEST, d)).astype(np.float32), 10.0
            else:
                xn, _, yn = highd_data(np, N, N_TEST, d)
                ls = HD_LENGTH_SCALE
            X, Y = torch.as_tensor(xn, device=dev), torch.as_tensor(yn, device=dev)
            for form, (A, B, dg) in (("cross", (X, Y, None)), ("covariance", (X, X, diag))):
                def branch():
                    return radial_gram(A, B, ls, 1.0, PROFILE, diag_add=dg)

                def loop():
                    return loop_gram(torch, _build, A, B, ls, 1.0, PROFILE, dg)

                err = (branch() - loop()).abs().max().item()
                turns = [cuda_ms(torch, f, reps=3, batch=5) for f in (loop, branch, branch, loop)]
                refined = tiled_squared_distances(A, B, ls, PROFILE)[1]
                bound_ms, bound_by = highd_bound(A.shape[0], B.shape[0], d, form == "covariance", dg is not None)
                row = {"kind": kind, "d": d, "form": form, "shape": [A.shape[0], B.shape[0]], "ls": ls,
                       "ms": turns[1:3], "loop_ms": [turns[0], turns[3]], "max_abs_diff_loop": err,
                       "refined_share": refined.float().mean().item(), "bound_ms": bound_ms, "bound_by": bound_by}
                rows.append(row)
                print(f"[{card}] high-D sweep {kind} {form} {tuple(row['shape'])} D={d}: branch "
                      f"{turns[1]:.4f} / {turns[2]:.4f} ms, the elementwise loop {turns[0]:.4f} / {turns[3]:.4f} "
                      f"ms (in turns), bound {bound_ms:.4f} ms by {bound_by} ({bound_ms / min(turns[1:3]):.1%} of "
                      f"it); refined share by the rule {row['refined_share']:.4f}; max|branch - loop| {err:.3e}")
                del refined
            del X, Y
            torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def gram_replaced(rg, gram):
    """Every radial gram of the port computed by ``gram`` instead (the
    fused training covariance and the DSL's Euclidean terms both call
    ``radial_gram`` through its module)."""
    kept = rg.radial_gram
    rg.radial_gram = gram
    try:
        yield
    finally:
        rg.radial_gram = kept


def check_highd(torch, np, pt, _build, config, card: str) -> dict:
    """Phase (i): the 32-feature GP on the gram kernel's high-D branch.
    The four launch forms at the path's shapes against the tiled plain
    version and f64 (the refined share, bitwise symmetry, exact diagonal,
    column blocks and walker slices bit-equal to the materialized and
    unbatched kernel), timed beside the bound and the library yardstick;
    the main path at N (NLML, fit + predict of N_TEST points) against f64
    on the card, with a single-pass TF32 contraction and an uncentred
    cdist control; value+grad at N with the backward's d^2 launch and with
    the closed form (time, peak memory); value+grad at N_GRAD and the
    sampler there against f64; the lazy NLML at N_LAZY against f64.
    Returns the kernel rows, the launches of each path and the phase's."""
    import importlib

    from albatross_tpu_torch.ops.radial_gram import (
        apply_profile,
        plain_radial_gram,
        plain_radial_gram_tiled,
        radial_gram,
        radial_gram_cols,
        radial_gram_diag_batched,
        tiled_squared_distances,
    )
    from albatross_tpu_torch.samplers import ensemble_sampler_from_model, initial_params_from_jitter
    from albatross_tpu_torch.samplers.ensemble import model_log_prob_fn

    rg = importlib.import_module("albatross_tpu_torch.ops.radial_gram")
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    ls, profile = HD_LENGTH_SCALE, PROFILE
    X_np, y_np, Xs_np = highd_data(np, N, N_TEST)
    X, Xs = torch.as_tensor(X_np, device=dev), torch.as_tensor(Xs_np, device=dev)
    diag = torch.full((N,), NOISE * NOISE + JITTER, dtype=torch.float32, device=dev)
    phase = {name: 0 for name in _build.LAUNCHES}
    results, errors = {}, {}

    def tally(counts):
        for k, v in counts.items():
            phase[k] += v

    def tf32_gram(A, B, length_scale, sigma, profile="squared_exponential", diag_add=None):
        """The control: the tiled version with a single-pass TF32 contraction."""
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return plain_radial_gram_tiled(A, B, length_scale, sigma, profile, diag_add)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    def uncentred_gram(A, B, length_scale, sigma, profile="squared_exponential", diag_add=None):
        """The control: |x|^2 + |y|^2 - 2 x.y over the raw coordinates."""
        out = apply_profile(profile, torch.cdist(A, B, compute_mode="use_mm_for_euclid_dist") ** 2, length_scale,
                            sigma)
        if diag_add is not None:
            out.diagonal().add_(diag_add)
        return out

    controls = {"single-pass TF32": tf32_gram, "uncentred cdist": uncentred_gram}
    control_errors = {name: {} for name in controls}

    # -- the two materialized forms at the main path's shapes ---------------
    for name, (A, B, dg, key) in (("radial_gram_diag_highd", (X, X, diag, "covariance")),
                                  ("radial_gram_highd", (X, Xs, None, "cross"))):
        _build.reset_launch_counts()
        got = radial_gram(A, B, ls, SIGMA, profile, diag_add=dg)
        counts = dict(_build.LAUNCHES)
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"{name}: launches {counts}")
        sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        print(f"{name} sha256 {sha} (the first tensor-core design's: {HD_FIRST_DESIGN_SHA256[key]})")
        tiled = plain_radial_gram_tiled(A, B, ls, SIGMA, profile, dg)
        err = (got - tiled).abs().max().item()
        del tiled
        _, refined = tiled_squared_distances(A, B, ls, profile)
        near = refined.to(dev).repeat_interleave(128, 0).repeat_interleave(128, 1)[:A.shape[0], :B.shape[0]]
        exact = plain_radial_gram(A.double(), B.double(), ls, SIGMA, profile, None if dg is None else dg.double())

        def gram_errors(out):
            """(largest |out - f64|, the same over the tiles the rule leaves
            to the contraction)."""
            diff = (out.double() - exact).abs_()
            return diff.max().item(), diff.masked_fill_(near, 0.0).max().item()

        errors[key], errors[f"{key} far field"] = gram_errors(got)
        line = ""
        if dg is not None:
            s32 = torch.tensor(SIGMA, dtype=torch.float32, device=dev)
            if not torch.equal(got, got.T) or not torch.equal(got.diagonal(), s32 * s32 + dg):
                fail(f"{name}: not bitwise symmetric with sigma^2 + diag on its diagonal")
            line = "; bitwise symmetric, diagonal exactly sigma^2 + diag"
        del got
        for control, gram in controls.items():
            out = gram(A, B, ls, SIGMA, profile, dg)
            control_errors[control][key], control_errors[control][f"{key} far field"] = gram_errors(out)
            del out
        del exact, near
        print(f"{name} ({A.shape[0]}, {B.shape[0]}) D={HD_D} f32: max|kernel - tiled plain| = {err:.3e} (tol "
              f"{GRAM_F32_TOL:g} sigma^2), max|kernel - f64| = {errors[key]:.3e}, over the tiles left to the "
              f"contraction {errors[f'{key} far field']:.3e}; refined tiles "
              f"{refined.float().mean().item():.4f} of {refined.numel()}{line}")
        if not err <= GRAM_F32_TOL * SIGMA**2:
            fail(f"{name} disagrees with its plain version: {err}")

        def kernel():
            return radial_gram(A, B, ls, SIGMA, profile, diag_add=dg)

        def library(mode="use_mm_for_euclid_dist"):
            return apply_profile(profile, torch.cdist(A, B, compute_mode=mode) ** 2, ls, SIGMA)

        r = {"max_abs_err": err, "refined_share": refined.float().mean().item(),
             "ms": cuda_ms(torch, kernel),
             "plain_ms": cuda_ms(torch, lambda: plain_radial_gram_tiled(A, B, ls, SIGMA, profile, dg), reps=3,
                                 batch=1),
             "library_cdist_mm_ms": cuda_ms(torch, library, reps=3, batch=3),
             "library_cdist_ms": cuda_ms(torch, lambda: library("donot_use_mm_for_euclid_dist"), reps=1, batch=1)}
        ref = plain_radial_gram(A.double(), B.double(), ls, SIGMA, profile)
        r["library_cdist_mm_err"] = (library().double() - ref).abs().max().item()
        r["library_cdist_err"] = (library("donot_use_mm_for_euclid_dist").double() - ref).abs().max().item()
        del ref
        r["bound_ms"], r["bound_by"] = highd_bound(A.shape[0], B.shape[0], HD_D, dg is not None, dg is not None)
        r["sha256"] = sha
        tile_rate(r, highd_tiles(A.shape[0], B.shape[0], dg is not None))
        results[name] = r
        print(f"[{card}] {name} ({A.shape[0]}, {B.shape[0]}) D={HD_D}: kernel {r['ms']:.4f} ms, tiled plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({r['bound_ms'] / r['ms']:.1%} "
              f"of it); library yardstick torch.cdist + apply_profile: with mm {r['library_cdist_mm_ms']:.4f} ms "
              f"(max err vs f64 {r['library_cdist_mm_err']:.3e}), without {r['library_cdist_ms']:.4f} ms (max err "
              f"{r['library_cdist_err']:.3e})")
        torch.cuda.empty_cache()

    # -- the main path at N, against f64 on the card -------------------------
    model = highd_model(pt)
    data = pt.RegressionDataset.create(X_np, y_np, dtype=torch.float32)
    _build.reset_launch_counts()
    ll = model.log_likelihood(data)
    torch.cuda.synchronize()
    nlml_counts = dict(_build.LAUNCHES)
    pred = model.fit(data).predict(Xs).marginal()
    torch.cuda.synchronize()
    path_counts = dict(_build.LAUNCHES)
    tally(path_counts)
    print(f"phase (i) launches in log_likelihood: {nlml_counts}; in NLML + fit + predict: {path_counts}")
    if (nlml_counts["radial_gram_diag_highd"] != 1 or nlml_counts["panel_cholinv"] != PANELS
            or nlml_counts["radial_gram_diag"] != 0):
        fail(f"phase (i) log_likelihood launch counts {nlml_counts}")
    if (path_counts["radial_gram_highd"] < 1 or path_counts["radial_gram_diag_highd"] != 2
            or path_counts["radial_gram"] != 0 or path_counts["radial_gram_diag"] != 0):
        fail(f"phase (i) main-path launch counts {path_counts}")
    data64 = pt.RegressionDataset.create(X_np.astype(np.float64), y_np.astype(np.float64), dtype=torch.float64)
    Xs64 = Xs.double()
    ll64 = model.log_likelihood(data64).item()
    pred64 = model.fit(data64).predict(Xs64).marginal()

    def path_errors(ll, pred):
        if pred.mean.shape != (N_TEST,) or pred.variance.shape != (N_TEST,):
            fail(f"phase (i) predict shapes {tuple(pred.mean.shape)}, {tuple(pred.variance.shape)}")
        return {"nlml": abs(ll.item() - ll64) / abs(ll64),
                "mean": (pred.mean.double() - pred64.mean).abs().max().item(),
                "variance": (pred.variance.double() - pred64.variance).abs().max().item()}

    errors.update(path_errors(ll, pred))
    print(f"phase (i) log_likelihood N={N} D={HD_D} f32 = {ll.item()!r}, f64 on the card = {ll64!r}")
    del pred
    for control, gram in controls.items():
        with gram_replaced(rg, gram):
            control_errors[control].update(path_errors(model.log_likelihood(data), model.fit(data).predict(Xs).marginal()))
    keys = ("covariance", "covariance far field", "cross", "cross far field", "nlml", "mean", "variance")
    check_gates(f"phase (i) main path N={N} D={HD_D} against f64", {k: errors[k] for k in keys}, HD_TOLS)
    for control, errs in control_errors.items():
        failed = [k for k in keys if not errs[k] <= HD_TOLS[k]]
        print(f"phase (i) {control} control: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; rejected by the gates of {failed}")
        if not failed:
            fail(f"phase (i) gates accept the {control} control: {errs}")
    del data64, pred64
    nlml_times = wall_times(torch, lambda: model.log_likelihood(data), REPS)
    fp_times = wall_times(torch, lambda: model.fit(data).predict(Xs).marginal(), 3)
    print(f"[{card}] phase (i) NLML N={N} D={HD_D} f32: {statistics.median(nlml_times):.4f} s/eval (median of "
          f"{REPS}; all {nlml_times}); fit + predict marginal ({N} -> {N_TEST}): {statistics.median(fp_times):.4f} s "
          f"(median of 3; all {fp_times})")

    # -- value+grad at N: the backward's d^2 launches, and the closed form ------
    def d2_blocks(n):
        return len(range(0, n, rg.d2_block_width(n, n)))

    for way in ("d^2 from the kernel", "closed form"):
        kept = rg._kernel_d2_backward
        if way == "closed form":
            rg._kernel_d2_backward = lambda X, needs: False
        try:
            value_grad(torch, model, data)  # warm-up
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            times = wall_times(torch, lambda: value_grad(torch, model, data), 2)
            counts = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            rg._kernel_d2_backward = kept
        print(f"[{card}] phase (i) value+grad N={N} D={HD_D} f32, backward by {way}: "
              f"{statistics.median(times):.4f} s/eval (median of 2; all {times}); peak device memory {peak:.2f} GiB; "
              f"launches {counts}")
        if counts["radial_gram_d2_highd"] != (2 * d2_blocks(N) if way != "closed form" else 0):
            fail(f"phase (i) value+grad by {way}: launches {counts}")
        results.setdefault("value_grad", {})[way] = {"s": statistics.median(times), "peak_gib": peak,
                                                     "d2_launches": counts["radial_gram_d2_highd"]}

    # the backward's d^2 blocks (profile id 4) at the value+grad shape against the tiled version
    width = rg.d2_block_width(N, N)
    d2_err = 0.0
    for j0 in (0, width, N - N % width if N % width else N - width):
        b = min(width, N - j0)
        got = rg._launch(X[j0:], X[j0:j0 + b], ls, 1.0, None, profile, "radial_gram_d2", (X, j0, b),
                         squared_distance=True)
        ref = tiled_squared_distances(X[j0:], X[j0:j0 + b], ls, profile)[0]
        d2_err = max(d2_err, ((got - ref).abs().max() / ref.abs().max()).item())
        del got, ref
    print(f"radial_gram_d2_highd N={N} D={HD_D}: the backward's {d2_blocks(N)} column blocks of width {width}; "
          f"blocks at j0 = 0, {width}, the last against tiled_squared_distances: max|kernel - tiled| over the "
          f"block's largest d^2 {d2_err:.3e} (tol {HD_D2_REL_TOL:g})")
    if not d2_err <= HD_D2_REL_TOL:
        fail(f"phase (i) the d^2 launches disagree with tiled_squared_distances: {d2_err}")
    results["value_grad"]["d2_max_rel_err"] = d2_err

    # -- value+grad and the sampler at N_GRAD --------------------------------
    Xg_np, yg_np, _ = highd_data(np, N_GRAD, 1)
    data_g = pt.RegressionDataset.create(Xg_np, yg_np, dtype=torch.float32)
    _build.reset_launch_counts()
    value, grad = value_grad(torch, model, data_g)
    grad_counts = dict(_build.LAUNCHES)
    tally(grad_counts)
    check_counts(f"phase (i) value+grad N={N_GRAD}", grad_counts,
                 {"radial_gram_diag_highd": 1, "radial_gram_d2_highd": d2_blocks(N_GRAD),
                  "panel_cholinv": PANELS_GRAD, "radial_gram_diag": 0})
    x64 = torch.as_tensor(Xg_np, dtype=torch.float64, device=dev)
    y64 = torch.as_tensor(yg_np, dtype=torch.float64, device=dev)
    ref = reference_value_grad(torch, model, x64, y64, profile)
    errors["value"], errors["gradient"] = grad_errors(value, grad, ref)
    del x64, y64

    data_g64 = pt.RegressionDataset.create(Xg_np.astype(np.float64), yg_np.astype(np.float64), dtype=torch.float64)
    walkers = initial_params_from_jitter(HD_SEED, model.get_tunable_parameters().values, W_SAMPLER)
    ref64 = torch.stack([model.set_tunable_params(w).log_likelihood(data_g64).cpu() for w in walkers])
    per32 = torch.stack([model.set_tunable_params(w).log_likelihood(data_g).cpu().double() for w in walkers])
    _build.reset_launch_counts()
    got = model_log_prob_fn(model, data_g)(walkers)
    errors["sampler"], errors["sampler per-walker f32"] = max_rel(got, ref64), max_rel(got, per32)
    chain = ensemble_sampler_from_model(model, data_g, W_SAMPLER, HD_SAMPLER_ITERATIONS, key=HD_SEED)
    torch.cuda.synchronize()
    sampler_counts = dict(_build.LAUNCHES)
    tally(sampler_counts)
    rate = chain.acceptance_rate()
    print(f"phase (i) sampler N={N_GRAD}, {W_SAMPLER} walkers, {HD_SAMPLER_ITERATIONS} iterations: acceptance "
          f"{rate:.3f}; launches {sampler_counts}")
    if not (np.isfinite(chain.log_prob[-1]).all() and 0.0 < rate < 1.0):
        fail(f"phase (i) sampler chain: acceptance {rate}, final log-probs {chain.log_prob[-1]}")
    if (sampler_counts["radial_gram_diag_batched_highd"] < 2 + 2 * HD_SAMPLER_ITERATIONS
            or sampler_counts["radial_gram_diag_batched"] != 0):
        fail(f"phase (i) sampler launch counts {sampler_counts}")
    del data_g64

    # the batched form at the sampler's shape: slices against the unbatched kernel and the tiled version
    g = torch.Generator().manual_seed(HD_SEED)
    xg = data_g.features
    lsw = (ls * (0.8 + 0.4 * torch.rand(W_KERNEL, generator=g))).to(dev)
    sgw = (SIGMA * (0.8 + 0.4 * torch.rand(W_KERNEL, generator=g))).to(dev)
    dgw = torch.full((W_KERNEL, N_GRAD), NOISE * NOISE + JITTER, dtype=torch.float32, device=dev)
    _build.reset_launch_counts()
    Kb = radial_gram_diag_batched(xg, lsw, sgw, dgw, profile)
    if _build.LAUNCHES["radial_gram_diag_batched_highd"] != 1:
        fail(f"phase (i) batched gram launches {dict(_build.LAUNCHES)}")
    equal, err = True, 0.0
    for w in range(W_KERNEL):
        one = radial_gram(xg, xg, lsw[w].item(), sgw[w].item(), profile, diag_add=dgw[w])
        equal &= bool(torch.equal(Kb[w], one))
        if w < 2:
            tiled = plain_radial_gram_tiled(xg, xg, lsw[w].item(), sgw[w].item(), profile, dgw[w])
            err = max(err, (Kb[w] - tiled).abs().max().item())
    _, refined = tiled_squared_distances(xg, xg, ls, profile)
    del Kb, one, tiled
    print(f"radial_gram_diag_batched_highd ({W_KERNEL}, {N_GRAD}, {N_GRAD}) D={HD_D} f32: slices bit-equal to the "
          f"unbatched kernel: {equal}; max|kernel - tiled plain| = {err:.3e} over 2 walkers")
    if not (equal and err <= GRAM_F32_TOL * sgw.max().item() ** 2):
        fail(f"phase (i) batched gram: slices equal {equal}, plain {err}")
    one_bound, _ = highd_bound(N_GRAD, N_GRAD, HD_D, True, True)
    r = {"max_abs_err": err, "refined_share": refined.float().mean().item(),
         "ms": cuda_ms(torch, lambda: radial_gram_diag_batched(xg, lsw, sgw, dgw, profile)),
         "plain_ms": W_KERNEL * cuda_ms(torch, lambda: plain_radial_gram_tiled(xg, xg, ls, SIGMA, profile, dgw[0]),
                                        reps=3, batch=1),
         "bound_ms": W_KERNEL * one_bound, "bound_by": "bytes",
         "library_cdist_mm_ms": W_KERNEL * cuda_ms(torch, lambda: apply_profile(
             profile, torch.cdist(xg, xg, compute_mode="use_mm_for_euclid_dist") ** 2, ls, SIGMA), reps=3, batch=3)}
    tile_rate(r, W_KERNEL * highd_tiles(N_GRAD, N_GRAD, True))
    results["radial_gram_diag_batched_highd"] = r
    print(f"[{card}] radial_gram_diag_batched_highd ({W_KERNEL}, {N_GRAD}, {N_GRAD}) D={HD_D}: kernel {r['ms']:.4f} "
          f"ms, tiled plain {r['plain_ms']:.4f} ms ({W_KERNEL} walkers in turn), bound {r['bound_ms']:.4f} ms "
          f"({r['bound_ms'] / r['ms']:.1%} of it); refined tiles {r['refined_share']:.4f}; cdist with mm + profile, "
          f"{W_KERNEL} in turn, {r['library_cdist_mm_ms']:.4f} ms")

    # -- the lazy loop at N_LAZY ---------------------------------------------
    XL_np, yL_np, _ = highd_data(np, N_LAZY, 1)
    data_l = pt.RegressionDataset.create(XL_np, yL_np, dtype=torch.float32)
    _build.reset_launch_counts()
    t = time.perf_counter()
    ll_lazy = model.log_likelihood(data_l).item()
    torch.cuda.synchronize()
    lazy_s = time.perf_counter() - t
    lazy_counts = dict(_build.LAUNCHES)
    tally(lazy_counts)
    check_counts(f"phase (i) lazy NLML N={N_LAZY}", lazy_counts,
                 {"radial_gram_cols_highd": PANELS_LAZY, "panel_cholinv": PANELS_LAZY, "radial_gram_cols": 0,
                  "radial_gram_diag_highd": 0})
    data_l64 = pt.RegressionDataset.create(XL_np.astype(np.float64), yL_np.astype(np.float64), dtype=torch.float64)
    ll_lazy64 = model.log_likelihood(data_l64).item()
    errors["lazy nlml"] = abs(ll_lazy - ll_lazy64) / abs(ll_lazy64)
    del data_l64
    print(f"[{card}] phase (i) lazy NLML N={N_LAZY} D={HD_D} f32: {ll_lazy!r} (f64 {ll_lazy64!r}) in {lazy_s:.3f} s "
          f"(the first evaluation)")
    lazy_vg = {}
    for way in ("d^2 from the kernel", "closed form"):
        kept = rg._kernel_d2_backward
        if way == "closed form":
            rg._kernel_d2_backward = lambda X, needs: False
        try:
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launch_counts()
            t = time.perf_counter()
            value, grad = value_grad(torch, model, data_l)
            seconds = time.perf_counter() - t
            counts = dict(_build.LAUNCHES)
            peak = torch.cuda.max_memory_allocated() / 2**30
        finally:
            rg._kernel_d2_backward = kept
        lazy_vg[way] = (value.item(), grad)
        print(f"[{card}] phase (i) lazy value+grad N={N_LAZY} D={HD_D} f32, backward by {way}: {seconds:.3f} s (one "
              f"evaluation); peak device memory {peak:.2f} GiB; launches {counts}")
        check_counts(f"phase (i) lazy value+grad N={N_LAZY} by {way}", counts,
                     {"radial_gram_cols_highd": PANELS_LAZY, "panel_cholinv": PANELS_LAZY,
                      "radial_gram_d2_highd": PANELS_LAZY if way != "closed form" else 0,
                      "radial_gram_diag_highd": 0})
        results.setdefault("lazy_value_grad", {})[way] = {"s": seconds, "peak_gib": peak}
    (v_kernel, g_kernel), (v_closed, g_closed) = lazy_vg.values()
    errors["lazy value+grad value"] = abs(-v_kernel - ll_lazy64) / abs(ll_lazy64)
    routes = ((g_kernel - g_closed).abs().max() / g_closed.abs().max()).item()
    print(f"phase (i) lazy value+grad N={N_LAZY}: value {v_kernel!r} (closed form {v_closed!r}; f64 NLML "
          f"{ll_lazy64!r}), gradient {g_kernel.tolist()}, against the closed form's {routes:.3e} of its largest "
          f"entry (tol {HD_LAZY_GRAD_ROUTES_TOL:g})")
    if not (torch.isfinite(g_kernel).all() and routes <= HD_LAZY_GRAD_ROUTES_TOL):
        fail(f"phase (i) lazy value+grad: the two backwards' gradients differ by {routes}")
    del lazy_vg, g_kernel, g_closed, value, grad
    xl = data_l.features
    diag_l = torch.full((N_LAZY,), NOISE * NOISE + JITTER, dtype=torch.float32, device=dev)
    K_l = radial_gram(xl, xl, ls, SIGMA, profile, diag_add=diag_l)
    equal = True
    for j0 in (0, COL_B, N_LAZY - COL_B):
        equal &= bool(torch.equal(radial_gram_cols(xl, j0, COL_B, ls, SIGMA, profile, diag_l),
                                  K_l[j0:, j0:j0 + COL_B]))
    del K_l
    cols_err = 0.0
    for j0 in (0, N_LAZY - COL_B):  # the cross form of the tiled version keeps the grid where j0 % 128 == 0
        col = radial_gram_cols(xl, j0, COL_B, ls, SIGMA, profile, diag_l)
        tiled = plain_radial_gram_tiled(xl[j0:], xl[j0:j0 + COL_B], ls, SIGMA, profile, diag_l[j0:j0 + COL_B])
        cols_err = max(cols_err, (col - tiled).abs().max().item())
    del col, tiled
    print(f"radial_gram_cols_highd N={N_LAZY} D={HD_D}: blocks at j0 = 0, {COL_B}, {N_LAZY - COL_B} bit-equal to the "
          f"materialized training covariance: {equal}; max|kernel - tiled plain| = {cols_err:.3e}")
    if not (equal and cols_err <= GRAM_F32_TOL * SIGMA**2):
        fail(f"phase (i) column blocks: equal {equal}, plain {cols_err}")
    starts = range(0, N_LAZY, COL_B)

    def group():
        for j0 in starts:
            radial_gram_cols(xl, j0, COL_B, ls, SIGMA, profile, diag_l)

    def plain_group():
        for j0 in starts:
            plain_radial_gram_tiled(xl[j0:], xl[j0:j0 + COL_B], ls, SIGMA, profile, diag_l[j0:j0 + COL_B])

    def library_group():  # torch.cdist + apply_profile a block: the two-call yardstick
        for j0 in starts:
            block = apply_profile(profile, torch.cdist(xl[j0:], xl[j0:j0 + COL_B],
                                                       compute_mode="use_mm_for_euclid_dist") ** 2, ls, SIGMA)
            block[:COL_B].diagonal().add_(diag_l[j0:j0 + COL_B])

    # the group's bound: x[j0:] and the diagonal read, each (N_LAZY - j0, b) block written; the contraction
    # and the profile of every block
    by_bytes = by_ops = 0.0
    for j0 in starts:
        rows, cols = N_LAZY - j0, min(COL_B, N_LAZY - j0)
        by_bytes += 4 * (rows * cols + rows * HD_D + cols) / HBM_BYTES_PER_S
        by_ops += 2 * HD_D * rows * cols / TF32_FLOP_PER_S + 7 * rows * cols / FP32_FLOP_PER_S
    r = {"max_abs_err": cols_err, "ms": cuda_ms(torch, group, batch=2),
         "plain_ms": cuda_ms(torch, plain_group, reps=1, batch=1), "bound_ms": 1e3 * max(by_bytes, by_ops),
         "bound_by": "bytes" if by_bytes >= by_ops else "operations", "lazy_s": lazy_s,
         "library_cdist_mm_ms": cuda_ms(torch, library_group, reps=3, batch=1)}
    tile_rate(r, sum(rg._sym_tiles(N_LAZY, j0, COL_B) for j0 in starts))
    results["radial_gram_cols_highd"] = r
    print(f"[{card}] radial_gram_cols_highd, the {len(starts)} column launches of one lazy NLML N={N_LAZY} D={HD_D} as "
          f"one group: kernel {r['ms']:.4f} ms, tiled plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_ms'] / r['ms']:.1%} of it); cdist with mm + profile a block {r['library_cdist_mm_ms']:.4f} ms")

    check_gates(f"phase (i) against f64 on the card", errors, HD_TOLS)
    results["radial_gram_highd"]["sweep"] = highd_sweep(torch, np, _build, card)
    launches = {"radial_gram_highd": path_counts["radial_gram_highd"],
                "radial_gram_diag_highd": path_counts["radial_gram_diag_highd"],
                "radial_gram_cols_highd": lazy_counts["radial_gram_cols_highd"],
                "radial_gram_diag_batched_highd": sampler_counts["radial_gram_diag_batched_highd"]}
    print(f"[{card}] phase (i), the 32-feature GP: {time.perf_counter() - t_phase:.1f} s")
    return {"results": results, "launches": launches, "phase": phase, "value_grad_launches": grad_counts}


def trailing_flops(panels: int, b: int) -> tuple[float, float]:
    """(forward, backward) FLOP of one panel's trailing update at P = panels
    later column panels of width b: the forward's P (P + 1) / 2 products of
    (rows, b) by (b, b), the backward's twice that."""
    forward = 2.0 * b**3 * panels * (panels + 1) / 2
    return forward, 2 * forward


def library_trailing(B, cols):
    """The trailing update as cuBLAS ran it before the kernel (one addmm_ a
    column panel): chip_smoke's yardstick, which the port never calls."""
    b = B.shape[1]
    for i, C in enumerate(cols):
        C.addmm_(B[i * b:], B[i * b:(i + 1) * b].T, alpha=-1.0)


def library_trailing_backward(torch, B, grads):
    b = B.shape[1]
    gB = torch.zeros_like(B)
    for i, G in enumerate(grads):
        gB[i * b:].addmm_(G, B[i * b:(i + 1) * b], alpha=-1.0)
        gB[i * b:(i + 1) * b].addmm_(G.T, B[i * b:], alpha=-1.0)
    return gB


def check_trailing(torch, _build, card: str) -> dict:
    """The trailing-update kernel (ops/trailing_update.py) at b = 1024 and
    P = 27 / 13 / 1 later column panels (B of 27648 / 13312 / 1024 rows:
    the main path's first, middle and last panels), forward and backward:
    against f64 (the gate: within TRAIL_F64_TIMES of cuBLAS's FP32 error
    on the same inputs) and against its plain version; one launch each;
    bit-equal across two runs; CUDA-event times beside the bound (the
    operations at 494.7 TFLOP/s and at 494.7 / 3, the 3xTF32 rate), the
    plain version and cuBLAS's addmm_ loop (the library column)."""
    from albatross_tpu_torch.ops.trailing_update import (
        plain_trailing_update,
        plain_trailing_update_backward,
        trailing_update,
        trailing_update_backward,
    )

    g = torch.Generator(device="cpu").manual_seed(SEED + 19)
    b = TRAIL_B
    rows = {}
    for panels in TRAIL_PANELS:
        R = panels * b
        # B as the loop makes it, rows of a factor: entries ~ 1 / sqrt(b); C an SPD-like trailing block
        B = (torch.randn((R, b), generator=g) / b**0.5).cuda()
        cols0 = [(torch.randn((R - i * b, b), generator=g) * 0.1).cuda() for i in range(panels)]
        grads = [torch.randn((R - i * b, b), generator=g).cuda() for i in range(panels)]
        # f64 reference, and cuBLAS's f32 error on the same inputs
        ref = [c.double() for c in cols0]
        library_trailing(B.double(), ref)
        lib = [c.clone() for c in cols0]
        library_trailing(B, lib)
        got = [c.clone() for c in cols0]
        _build.reset_launch_counts()
        trailing_update(B, got)
        counts = dict(_build.LAUNCHES)
        again = [c.clone() for c in cols0]
        trailing_update(B, again)
        plain = [c.clone() for c in cols0]
        plain_trailing_update(B, plain)
        scale = max(r.abs().max().item() for r in ref)
        err = max((a.double() - r).abs().max().item() for a, r in zip(got, ref)) / scale
        err_lib = max((a.double() - r).abs().max().item() for a, r in zip(lib, ref)) / scale
        err_plain = max((a - p).abs().max().item() for a, p in zip(got, plain)) / scale
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        gref = library_trailing_backward(torch, B.double(), [G.double() for G in grads])
        glib = library_trailing_backward(torch, B, grads)
        _build.reset_launch_counts()
        gB = trailing_update_backward(B, grads)
        bcounts = dict(_build.LAUNCHES)
        gB_again = trailing_update_backward(B, grads)
        gplain = plain_trailing_update_backward(B, grads)
        gscale = gref.abs().max().item()
        berr = (gB.double() - gref).abs().max().item() / gscale
        berr_lib = (glib.double() - gref).abs().max().item() / gscale
        berr_plain = (gB - gplain).abs().max().item() / gscale
        bsame = torch.equal(gB, gB_again)
        print(f"trailing_update b={b} P={panels} (B {R} x {b}): forward rel err vs f64 {err:.3e} (cuBLAS FP32 "
              f"{err_lib:.3e}), vs plain {err_plain:.3e}, bit-equal across runs {same}, launches "
              f"{counts['trailing_update']}; backward rel err {berr:.3e} (cuBLAS FP32 {berr_lib:.3e}), vs plain "
              f"{berr_plain:.3e}, bit-equal {bsame}, launches {bcounts['trailing_update_backward']}")
        if counts["trailing_update"] != 1 or sum(counts.values()) != 1:
            fail(f"trailing_update P={panels} launched {counts}")
        if bcounts["trailing_update_backward"] != 1 or sum(bcounts.values()) != 1:
            fail(f"trailing_update_backward P={panels} launched {bcounts}")
        if not (same and bsame):
            fail(f"trailing_update P={panels} is not bit-equal across two runs: forward {same}, backward {bsame}")
        if not (err <= TRAIL_F64_TIMES * err_lib and berr <= TRAIL_F64_TIMES * berr_lib):
            fail(f"trailing_update P={panels} is further from f64 than {TRAIL_F64_TIMES} times cuBLAS FP32: "
                 f"forward {err} against {err_lib}, backward {berr} against {berr_lib}")
        if not (err_plain <= TRAIL_PLAIN_TOL and berr_plain <= TRAIL_PLAIN_TOL):
            fail(f"trailing_update P={panels} disagrees with its plain version: {err_plain}, {berr_plain}")
        del ref, gref, lib, glib, again, gB_again, plain, gplain
        work = [c.clone() for c in cols0]
        f_flops, b_flops = trailing_flops(panels, b)
        r = {
            "ms": cuda_ms(torch, lambda: trailing_update(B, work)),
            "library_ms": cuda_ms(torch, lambda: library_trailing(B, work)),
            "plain_ms": cuda_ms(torch, lambda: plain_trailing_update(B, work), batch=2),
            "backward_ms": cuda_ms(torch, lambda: trailing_update_backward(B, grads)),
            "backward_library_ms": cuda_ms(torch, lambda: library_trailing_backward(torch, B, grads)),
            "backward_plain_ms": cuda_ms(torch, lambda: plain_trailing_update_backward(B, grads), batch=2),
            "bound_ms": f_flops / TF32_FLOP_PER_S * 1e3, "bound_3xtf32_ms": 3 * f_flops / TF32_FLOP_PER_S * 1e3,
            "backward_bound_ms": b_flops / TF32_FLOP_PER_S * 1e3,
            "backward_bound_3xtf32_ms": 3 * b_flops / TF32_FLOP_PER_S * 1e3,
            "max_rel_err": max(err, berr), "cublas_fp32_rel_err": max(err_lib, berr_lib),
        }
        for way, fl in (("", f_flops), ("backward_", b_flops)):
            print(f"[{card}] trailing_update {way or 'forward_'}P={panels}: {r[way + 'ms']:.4f} ms "
                  f"({fl / r[way + 'ms'] / 1e9:.1f} TFLOP/s), bound {r[way + 'bound_ms']:.4f} ms at 494.7 TFLOP/s "
                  f"({r[way + 'bound_ms'] / r[way + 'ms']:.1%}) and {r[way + 'bound_3xtf32_ms']:.4f} ms at the "
                  f"3xTF32 rate ({r[way + 'bound_3xtf32_ms'] / r[way + 'ms']:.1%}); cuBLAS addmm_ "
                  f"{r[way + 'library_ms']:.4f} ms ({fl / r[way + 'library_ms'] / 1e9:.1f} TFLOP/s); plain "
                  f"{r[way + 'plain_ms']:.4f} ms")
        rows[panels] = r
        del B, cols0, grads, got, gB, work
    return rows


def whiten_flops(n: int, mp: int, b: int) -> float:
    """FLOP of the whitening kernel at n training points, mp (padded)
    columns and panels of b: the updates' b^2 mp P (P - 1), and three
    products of b (b + 128) mp a panel (the whiten, its residual and its
    refinement, each over a lower triangle by whole tiles)."""
    panels = n // b
    return float(b * b * mp * panels * (panels - 1) + 3 * b * (b + 128) * mp * panels)


def two_trsm_variance(torch, L, cross):
    """The explained variance as the port formed it before the kernel:
    A^-1 k by two cuBLAS trsm (CholeskyFactor.solve), times k, summed by
    column; chip_smoke's yardstick, which the port no longer calls."""
    y = torch.linalg.solve_triangular(L, cross, upper=False)
    return torch.sum(torch.linalg.solve_triangular(L.T, y, upper=True) * cross, dim=0)


def check_whiten(torch, _build, card: str, x, xs, diag) -> dict:
    """The whitening kernel (ops/whiten.py) at the main path's shapes: the
    f32 factor of the N-point training covariance and the (N, N_TEST) cross
    covariance, and at N_TEST - 96 columns (padded to a multiple of 128).
    Against the substitution in f64 on the same factor (the gate: within
    WHITEN_F32_TIMES of the error of the plain one-solve form, cuBLAS's f32
    trsm) and against its split-product plain version; 4 P - 1 launches;
    bit-equal across two runs; CUDA-event times beside the bound (the
    operations at 494.7 / 3 TFLOP/s, the 3xTF32 rate), of the whole call
    and of its diagonal blocks and their inverses, the plain one-solve form
    and the two cuBLAS trsm (the library column)."""
    from albatross_tpu_torch.ops.blocked_cholesky import cuda_block_size
    from albatross_tpu_torch.ops.linalg import CholeskyFactor
    from albatross_tpu_torch.ops.radial_gram import radial_gram
    from albatross_tpu_torch.ops.whiten import (
        diagonal_blocks,
        plain_explained_variance,
        split_explained_variance,
        whiten_sumsq,
    )

    L = CholeskyFactor.factorize(radial_gram(x, x, LENGTH_SCALE, SIGMA, PROFILE, diag_add=diag),
                                 assume_symmetric=True).L
    b = cuda_block_size(N)
    r = {}
    for m in (N_TEST, N_TEST - 96):
        cross = radial_gram(x, xs[:m], LENGTH_SCALE, SIGMA, PROFILE)
        ref = torch.sum(torch.linalg.solve_triangular(L.double(), cross.double(), upper=False) ** 2, dim=0)
        scale = ref.abs().max().item()
        _build.reset_launch_counts()
        got = whiten_sumsq(L, cross)
        counts = dict(_build.LAUNCHES)
        same = torch.equal(got, whiten_sumsq(L, cross))
        errs = {"kernel": (got.double() - ref).abs().max().item() / scale}
        split = split_explained_variance(L, cross, b)
        for what, value in (("plain", plain_explained_variance(L, cross)),
                            ("two_trsm", two_trsm_variance(torch, L, cross)), ("split", split)):
            errs[what] = (value.double() - ref).abs().max().item() / scale
        errs["kernel_vs_split"] = (got - split).abs().max().item() / scale
        print(f"whiten_sumsq N={N} m={m} b={b}: rel err vs f64 on the same factor: kernel {errs['kernel']:.3e}, "
              f"plain one-solve f32 {errs['plain']:.3e}, two trsm f32 {errs['two_trsm']:.3e}, split plain "
              f"{errs['split']:.3e}; kernel vs split {errs['kernel_vs_split']:.3e}; bit-equal across runs {same}; "
              f"launches {counts['whiten_sumsq']}")
        if counts["whiten_sumsq"] != 4 * (N // b) - 1 or sum(counts.values()) != counts["whiten_sumsq"]:
            fail(f"whiten_sumsq m={m} launched {counts}")
        if not same:
            fail(f"whiten_sumsq m={m} is not bit-equal across two runs")
        if not errs["kernel"] <= WHITEN_F32_TIMES * errs["plain"]:
            fail(f"whiten_sumsq m={m} is further from f64 than {WHITEN_F32_TIMES} times cuBLAS's f32 solve: {errs}")
        if not errs["kernel_vs_split"] <= WHITEN_PLAIN_TOL:
            fail(f"whiten_sumsq m={m} disagrees with its plain version: {errs['kernel_vs_split']}")
        if m == N_TEST:
            r.update({f"{k}_rel_err": v for k, v in errs.items()})
    del ref, split
    cross = radial_gram(x, xs, LENGTH_SCALE, SIGMA, PROFILE)
    flops = whiten_flops(N, N_TEST, b)
    r.update({
        "ms": cuda_ms(torch, lambda: whiten_sumsq(L, cross)),
        "blocks_ms": cuda_ms(torch, lambda: diagonal_blocks(L, b)),
        "plain_ms": cuda_ms(torch, lambda: plain_explained_variance(L, cross), batch=2),
        "library_two_trsm_ms": cuda_ms(torch, lambda: two_trsm_variance(torch, L, cross), batch=2),
        "split_plain_ms": cuda_ms(torch, lambda: split_explained_variance(L, cross, b), reps=1, batch=1),
        "bound_ms": flops / TF32_FLOP_PER_S * 1e3, "bound_3xtf32_ms": 3 * flops / TF32_FLOP_PER_S * 1e3,
        "flops": flops,
    })
    launches_ms = r["ms"] - r["blocks_ms"]
    print(f"[{card}] whiten_sumsq ({N}, {N_TEST}), b={b}: {r['ms']:.4f} ms a call, of which the diagonal blocks and "
          f"their inverses {r['blocks_ms']:.4f} ms and the launches {launches_ms:.4f} ms "
          f"({flops / launches_ms / 1e9:.1f} TFLOP/s; {r['bound_3xtf32_ms'] / launches_ms:.1%} of the 3xTF32 bound "
          f"{r['bound_3xtf32_ms']:.4f} ms, {r['bound_ms'] / launches_ms:.1%} of {r['bound_ms']:.4f} ms at 494.7 "
          f"TFLOP/s); plain one-solve {r['plain_ms']:.4f} ms; two cuBLAS trsm {r['library_two_trsm_ms']:.4f} ms; "
          f"split plain {r['split_plain_ms']:.4f} ms")
    del L, cross
    return r


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
        if name == "panel_cholinv":
            print(f"  {ptxas_kernel(log, 'panel_cholinv_tasks')}")
        if name == "trailing_update":
            print(f"  {ptxas_kernel(log, 'trailing_kernel')}")
        if name == "radial_gram":  # the high-D branch (one profile's instance each)
            for kernel in ("highd_sums_kernel", "highd_tile_kernel", "highd_exact_kernel"):
                print(f"  {ptxas_kernel(log, kernel)}")
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
    hashes = {"covariance": hashlib.sha256(K.cpu().numpy().tobytes()).hexdigest()}
    del K, Kp

    C = radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile)
    hashes["cross"] = hashlib.sha256(C.cpu().numpy().tobytes()).hexdigest()
    print(f"D = 1 main path grams keep their bits: {hashes == MAIN_PATH_SHA256} (sha256 {hashes})")
    if hashes != MAIN_PATH_SHA256:
        fail(f"the D = 1 main path's grams changed: sha256 {hashes}, before {MAIN_PATH_SHA256}")
    err = (C - plain_radial_gram(x, xs, LENGTH_SCALE, SIGMA, profile)).abs().max().item()
    print(f"cross gram ({N}, {N_TEST}) D=1 f32: max|kernel - plain| = {err:.3e}")
    if not err <= GRAM_F32_TOL * SIGMA**2:
        fail(f"cross gram disagrees with its plain version: {err}")
    results["radial_gram"] = {"max_abs_err": err}
    cols_err = check_column_blocks(torch, x, diag)

    # the elementwise loop's staged instance (D > 4): every f32 gram at D = 5-7, every f64 one at D >= 5
    g7 = torch.Generator(device="cpu").manual_seed(SEED + 7)
    X7 = (10.0 * torch.rand((4096, 7), generator=g7)).to(dev)
    Y7 = (10.0 * torch.rand((2048, 7), generator=g7)).to(dev)
    _build.reset_launch_counts()
    K7 = radial_gram(X7, Y7, 3.0, 1.5, "matern_52")
    counts7 = dict(_build.LAUNCHES)
    ref7 = plain_radial_gram(X7.double(), Y7.double(), 3.0, 1.5, "matern_52")
    err = (K7.double() - ref7).abs().max().item()
    err_plain = (K7 - plain_radial_gram(X7, Y7, 3.0, 1.5, "matern_52")).abs().max().item()
    print(f"radial_gram (4096, 2048) D=7 matern_52 f32 (the loop's staged instance): max|kernel - f64| = {err:.3e}, "
          f"max|kernel - plain f32| = {err_plain:.3e} (tol {GRAM_F32_TOL:g} sigma^2); launches {counts7}")
    if counts7["radial_gram"] != 1 or sum(counts7.values()) != 1:
        fail(f"the D = 7 f32 gram did not launch the elementwise loop alone: {counts7}")
    if not (err <= GRAM_F32_TOL * 1.5**2 and err_plain <= GRAM_F32_TOL * 1.5**2):
        fail(f"the D = 7 f32 gram disagrees with the f64 closed form ({err}) or its plain version ({err_plain})")
    results["radial_gram"]["staged_d7_max_abs_err"] = max(err, err_plain)
    del K7, ref7

    # the high-D branch where every tile refines (U[0, 10]^16, Matern's cut d <= 27 against distances ~16)
    g = torch.Generator(device="cpu").manual_seed(SEED)
    X16 = (10.0 * torch.rand((4096, 16), generator=g)).to(dev)
    Y16 = (10.0 * torch.rand((2048, 16), generator=g)).to(dev)
    _build.reset_launch_counts()
    K16 = radial_gram(X16, Y16, 3.0, 1.5, "matern_52")
    counts16 = dict(_build.LAUNCHES)
    ref16 = plain_radial_gram(X16.double(), Y16.double(), 3.0, 1.5, "matern_52")
    err = (K16.double() - ref16).abs().max().item()
    err_plain = (plain_radial_gram(X16, Y16, 3.0, 1.5, "matern_52").double() - ref16).abs().max().item()
    print(f"radial_gram_highd (4096, 2048) D=16 matern_52 f32: max|kernel - f64| = {err:.3e}, max|plain f32 - f64| = "
          f"{err_plain:.3e}; launches {counts16}")
    if counts16["radial_gram_highd"] != 1 or sum(counts16.values()) != 1:
        fail(f"the D = 16 f32 gram did not launch the high-D branch alone: {counts16}")
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

    trailing = check_trailing(torch, _build, card)
    whiten = check_whiten(torch, _build, card, x, xs, diag)

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
            or path_counts["panel_cholinv"] != 2 * PANELS or path_counts["whiten_sumsq"] != 4 * PANELS - 1):
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
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=dev)

    def library_pair():
        """The same function by two library calls: cuSOLVER's potrf, then
        a trsm against the identity for the inverse."""
        return torch.linalg.solve_triangular(torch.linalg.cholesky(A), eye, upper=False)

    results["panel_cholinv"]["library_two_call_ms"] = cuda_ms(torch, library_pair)
    print(f"[{card}] panel_cholinv b={A.shape[0]} f32: the two library calls (torch.linalg.cholesky + "
          f"solve_triangular against the identity) {results['panel_cholinv']['library_two_call_ms']:.4f} ms")
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
    X7 = (10.0 * torch.rand((N, 7), generator=g7)).to(dev)
    Y7 = (10.0 * torch.rand((N_TEST, 7), generator=g7)).to(dev)
    r = results["radial_gram"]
    r["staged_d7_ms"] = cuda_ms(torch, lambda: radial_gram(X7, Y7, 3.0, 1.5, "matern_52"))
    r["staged_d7_bound_ms"], r["staged_d7_bound_by"] = gram_bound(N, N_TEST, 7, 4, square=False, diag=False)
    print(f"[{card}] radial_gram ({N}, {N_TEST}) D=7 matern_52 f32 (the loop's staged instance): kernel "
          f"{r['staged_d7_ms']:.4f} ms, bound {r['staged_d7_bound_ms']:.4f} ms by {r['staged_d7_bound_by']} "
          f"({r['staged_d7_bound_ms'] / r['staged_d7_ms']:.1%} of it)")
    X16 = (10.0 * torch.rand((N, 16), generator=g)).to(dev)
    Y16 = (10.0 * torch.rand((N_TEST, 16), generator=g)).to(dev)
    turns16 = [cuda_ms(torch, f) for f in (lambda: loop_gram(torch, _build, X16, Y16, 3.0, 1.5, "matern_52"),
                                           lambda: radial_gram(X16, Y16, 3.0, 1.5, "matern_52"))]
    bound16, by16 = highd_bound(N, N_TEST, 16, square=False, diag=False)
    highd_d16 = {"d16_matern_ms": turns16[1], "d16_matern_loop_ms": turns16[0], "d16_matern_bound_ms": bound16}
    print(f"[{card}] radial_gram_highd ({N}, {N_TEST}) D=16 matern_52 f32 (every tile refines): kernel "
          f"{turns16[1]:.4f} ms, the elementwise loop on the same inputs {turns16[0]:.4f} ms, bound {bound16:.4f} "
          f"ms by {by16} ({bound16 / turns16[1]:.1%} of it)")
    print(f"[{card}] panel_cholinv b=128 (one tile step): kernel "
          f"{cuda_ms(torch, lambda: panel_cholinv(A128)):.4f} ms, plain "
          f"{cuda_ms(torch, lambda: plain_panel_cholinv(A128)):.4f} ms")
    del X7, Y7, X16, Y16
    # the panel's backward (five b x b FP32 products through torch.matmul)
    U, Wu = panel_cholinv(A)
    gU, gW = torch.randn_like(U), torch.randn_like(Wu)
    b = A.shape[0]
    back_bound, back_by = bound(4 * 5 * b * b, 10 * b**3)
    back_ms = cuda_ms(torch, lambda: panel_cholinv_backward(U, Wu, gU, gW))
    print(f"[{card}] panel_cholinv backward b={b}: {back_ms:.4f} ms, bound {back_bound:.4f} ms by {back_by} "
          f"({back_bound / back_ms:.1%} of it)")
    time_value_grad_big(torch, _build, model, data, card, args)
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
    results.update(check_batched_kernels(torch, np, card, args.profile))
    sampler = check_sampler(torch, np, pt, _build, card, args)
    phase_counts["sampler"] = sampler["launches"]
    phase_counts["sampler_bench"] = sampler["bench_launches"]
    phase_counts["sampler_split"] = sampler["split_launches"]
    # -- the NLML accuracy modes and the distributed GP ------------------------
    check_eft(torch, card)
    phase_counts["accuracy_modes"] = check_accuracy_modes(torch, np, pt, _build, config, card, data, ll_ref_val,
                                                          args)
    phase_counts.update(check_distributed_one(torch, np, pt, _build, card))
    phase_counts.update(check_distributed_four(torch, np, pt, _build, card))
    # -- phase (h): the examples and tutorials at full size ----------------
    phase_counts.update(check_examples(torch, np, _build, card))
    # -- phase (i): the 32-feature GP on the gram kernel's high-D branch -----
    highd = check_highd(torch, np, pt, _build, config, card)
    phase_counts["highd"] = highd["phase"]

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
        if "library_two_call_ms" in r:  # two calls, so not the contract's one-call library_ms
            entry["library_two_call_ms"] = r["library_two_call_ms"]
        if "write_floor_ms" in r:
            entry["write_floor_ms"] = r["write_floor_ms"]
        entry.update({k: v for k, v in r.items() if k.startswith("staged_d7_")})
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
    for name, (source, replaces) in HD_SOURCES.items():  # phase (i)'s rows: their own path's launches
        r = highd["results"][name]
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": highd["launches"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            # no single PyTorch call computes a radial gram: torch.cdist + apply_profile is two
            "library_ms": None,
            "value_grad_launches": highd["value_grad_launches"][name],
        }
        entry.update({k: v for k, v in r.items() if k.startswith("library_") or k in (
            "refined_share", "lazy_s", "sweep", "tiles", "ns_per_tile", "sha256")})
        entry.update({f"{phase}_launches": counts[name] for phase, counts in phase_counts.items()})
        if name == "radial_gram_highd":
            entry.update(highd_d16)
        if name == "radial_gram_diag_highd":
            entry["value_grad_d2_launches"] = highd["value_grad_launches"]["radial_gram_d2_highd"]
            entry["value_grad_n"] = highd["results"]["value_grad"]
        if name == "radial_gram_cols_highd":
            entry["lazy_value_grad"] = highd["results"]["lazy_value_grad"]
        kernels.append(entry)
    for panels, r in trailing.items():  # no TPU kernel: the JAX package's HIGHEST GEMMs
        kernels.append({"name": f"trailing_update_P{panels}", "route": "cuda",
                        "source": "albatross_tpu_torch/csrc/trailing_update.cu",
                        "replaces": "XLA GEMMs, albatross_tpu/ops/blocked_cholesky.py", **r})
    kernels.append({"name": "whiten_sumsq", "route": "cuda", "source": "albatross_tpu_torch/csrc/whiten_sumsq.cu",
                    "replaces": "two XLA triangular solves, albatross_tpu/models/gp.py",
                    "launches": path_counts["whiten_sumsq"], "value_grad_launches": grad_counts["launches"]["whiten_sumsq"],
                    **{f"{phase}_launches": counts["whiten_sumsq"] for phase, counts in phase_counts.items()},
                    **whiten})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
