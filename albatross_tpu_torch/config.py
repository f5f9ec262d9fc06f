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

    ``None`` means the card: ``cuda``.  A CUDA request without a GPU raises;
    the CPU is used only when the caller asks for it (``"cpu"``, or CPU
    tensors), never as a fallback behind the caller's back."""
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was requested but torch.cuda.is_available() is False"
        )
    return dev
