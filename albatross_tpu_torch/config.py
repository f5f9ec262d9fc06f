"""Runtime configuration: device selection and f32 GEMM precision.

The JAX package runs every factorization GEMM at HIGHEST (f32-faithful)
precision.  The faithful counterpart here is full-f32 matmuls: TF32 keeps
about three decimal digits, which is what the JAX package's single-pass
bf16 default cost it (NaN factorizations at large N).  TF32 therefore
stays off for every torch matmul.  The blocked Cholesky's trailing update
runs on the tensor cores all the same, in its own kernel
(ops/trailing_update.py): 3xTF32, three TF32 products of split operands
summed in f32, which is f32-accurate; it has no switch of its own, and the
compensated accuracy mode (NLML_COMPENSATED) keeps the f32 GEMMs.

The TPU-only knobs of the JAX package are not ported:
``DW_DOT_ALGORITHM`` and ``CHOLESKY_TRAILING_BF16`` exist only because of
the TPU matrix unit's bf16 passes; ``USE_PALLAS_GRAM``,
``PALLAS_GRAM_MIN_ELEMENTS``, ``PALLAS_GRAM_AUTO_MIN_D`` and
``PANEL_FACTORIZER`` pick between XLA and a Pallas kernel on the TPU,
where the port always runs its hand-written kernels.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Loop order of the NLML's blocked factorization: "right" (the default)
# factors the materialized training covariance; "right_fused" is the same
# right-looking loop with lazy gram columns (ops/blocked_cholesky.py
# blocked_cholesky_cols_fused): the gram kernel writes each column panel's
# active rows straight into the buffer the loop updates, so no N x N
# covariance exists.  The JAX package's "left" loop order is not ported.
CHOLESKY_ALGORITHM: str = "right"

# At and above this N, a log_likelihood whose kernel matches the fused
# pattern upgrades "right" to "right_fused"; 0 disables the upgrade.  The
# reading behind it (``python -m albatross_tpu_torch.memory_ceiling``, bench
# model, f32, NVIDIA H100 80GB HBM3 at 700 W): the materialized value+grad
# peaks at 50.06 GiB at N = 40960 and 72.06 GiB at N = 49152, and runs out
# of the card's 79.18 GiB at N = 57344; by N^2 growth its ceiling is near
# N = 51500.  The JAX package's 57344 is the figure of a 16 GB TPU.
CHOLESKY_FUSED_MIN_N: int = 49152


# NLML accuracy mode (ops/compensated.py compensated_nll): double-word
# reductions for the log-determinant and the quadratic term, which two
# steps of iterative refinement with a double-word residual polish.  Read
# by GaussianProcess.log_likelihood; it factorizes the assembled training
# covariance.  Its factorizations keep the f32 GEMMs of the trailing update
# (ops/blocked_cholesky.py), which round both ways, instead of the 3xTF32
# kernel's truncating tensor-core sums.
NLML_COMPENSATED: bool = False

# Factorization accuracy mode, read by CholeskyFactor._factor_core and
# nlml_terms above n = 2048: None is the plain blocked loop; "double_word"
# carries the trailing matrix as an unevaluated (hi, lo) pair
# (ops/compensated.py blocked_cholesky_dw), so each panel's input is one
# rounding from exact; "high" and "highest" ask the JAX package for
# multi-pass bf16 products on the TPU, which every f32 product here
# already matches (full f32, TF32 off), so they take the default path.
CHOLESKY_PRECISION: str | None = None

# Panel size of the blocked factorization: None keeps the device's policy
# (ops/blocked_cholesky.py default_block_size); an int must be a multiple
# of 128, and on CUDA f32 at most MAX_CUDA_PANEL = 1024, the panel
# kernel's bound.
CHOLESKY_BLOCK_SIZE: int | None = None


def cholesky_precision() -> str | None:
    """``CHOLESKY_PRECISION``, checked: unknown names raise."""
    if CHOLESKY_PRECISION not in (None, "high", "highest", "double_word"):
        raise ValueError(f"unknown CHOLESKY_PRECISION {CHOLESKY_PRECISION!r}; "
                         'use None, "high", "highest" or "double_word"')
    return CHOLESKY_PRECISION


def cholesky_algorithm() -> str:
    """``CHOLESKY_ALGORITHM``, checked: "left" (the JAX package's
    left-looking loop, an opt-in alternative there) and unknown names
    raise."""
    if CHOLESKY_ALGORITHM == "left":
        raise ValueError('CHOLESKY_ALGORITHM = "left" (the left-looking loop) is not ported; '
                         'use "right" or "right_fused"')
    if CHOLESKY_ALGORITHM not in ("right", "right_fused"):
        raise ValueError(f"unknown CHOLESKY_ALGORITHM {CHOLESKY_ALGORITHM!r}")
    return CHOLESKY_ALGORITHM


def device(name: str | torch.device | None = None) -> torch.device:
    """Resolve a device request.

    ``None`` means the card: ``cuda``.  A CUDA request without a GPU raises;
    the CPU is used only when the caller asks for it (``"cpu"``, or CPU
    tensors), never as a fallback behind the caller's back."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is False"
        )
    return dev
