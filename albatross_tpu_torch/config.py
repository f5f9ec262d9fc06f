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


def device(name: str | torch.device | None = None) -> torch.device:
    """Resolve a device request.

    ``None`` picks ``cuda`` when a GPU is present and ``cpu`` otherwise.  An
    explicit CUDA request without a GPU raises: nothing falls back to the
    CPU behind the caller's back."""
    if name is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is False"
        )
    return dev
