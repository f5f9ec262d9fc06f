"""Panel Cholesky + triangular inverse: the CUDA kernel and its plain version.

Counterpart of ``albatross_tpu.ops.pallas_chol.pallas_panel_cholinv``: for a
b x b SPD panel (b % 128 == 0, b <= 1024, f32) return U = chol(A)^T and
Wu = U^-1, both upper-triangular with a strict lower triangle of exactly 0.
On CPU tensors the plain version is ``torch.linalg.cholesky`` plus
``blocked_tri_inverse``; on CUDA tensors ``csrc/panel_cholinv.cu`` runs, or
the call raises.  There is no gradient yet: inputs that require grad are
refused.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_T = 128


def plain_panel_cholinv(A: torch.Tensor, sub: int = 256):
    """(U, Wu) = (L^T, (L^-1)^T) from torch.linalg.cholesky and
    blocked_tri_inverse; a non-SPD panel gives NaN, as the kernel does."""
    from .blocked_cholesky import blocked_tri_inverse, cholesky

    L = cholesky(A)
    return L.T, blocked_tri_inverse(L, sub).T


def _launch(A: torch.Tensor):
    lib = _build.load("panel_cholinv")
    b = A.shape[0]
    U = torch.empty_like(A)
    Wu = torch.empty_like(A)
    scratch = torch.empty(b * _T, dtype=A.dtype, device=A.device)
    fn = lib.panel_cholinv_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = fn(A.data_ptr(), U.data_ptr(), Wu.data_ptr(), scratch.data_ptr(), b, stream)
    _build.count_launch("panel_cholinv")
    _build.check(lib, code, "panel_cholinv kernel")
    return U, Wu


def panel_cholinv(A: torch.Tensor):
    """(U, Wu) with U^T U = A and Wu = U^-1, both upper-triangular f32."""
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"panel_cholinv needs a square matrix, got {tuple(A.shape)}")
    b = A.shape[0]
    if b % _T != 0 or b > 1024:
        raise ValueError(
            f"pallas_panel_cholinv needs b % 128 == 0 and b <= 1024, got {b}"
        )
    if not A.is_cuda:
        return plain_panel_cholinv(A.to(torch.float32))
    if A.dtype != torch.float32:
        raise TypeError(f"panel_cholinv kernel takes f32, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("panel_cholinv kernel needs a contiguous panel")
    if A.requires_grad:
        raise RuntimeError(
            "panel_cholinv has no backward yet: call it on a tensor that "
            "does not require grad"
        )
    return _launch(A)
