"""Runtime configuration: device selection and f32 GEMM precision.

The JAX package runs every factorization GEMM at HIGHEST (f32-faithful)
precision.  The faithful counterpart here is full-f32 matmuls: TF32 keeps
about three decimal digits, which is what the JAX package's single-pass
bf16 default cost it (NaN factorizations at large N).  TF32 is therefore
off; enabling it is an explicit opt-in for a later change.

The TPU-only knobs of the JAX package (``DW_DOT_ALGORITHM``,
``CHOLESKY_TRAILING_BF16``) are not ported: both exist only because of
the TPU matrix unit's bf16 passes.
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
