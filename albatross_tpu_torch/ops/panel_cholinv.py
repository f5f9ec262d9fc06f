"""Panel Cholesky + triangular inverse: the CUDA kernel, its plain version
and its backward.

Counterpart of ``albatross_tpu.ops.pallas_chol.pallas_panel_cholinv``: for a
b x b SPD panel (b % 128 == 0, b <= 1024, f32) return U = chol(A)^T and
Wu = U^-1, both upper-triangular with a strict lower triangle of exactly 0.
On CPU tensors the plain version is ``torch.linalg.cholesky`` plus
``blocked_tri_inverse``, in the input's dtype; on CUDA tensors
``csrc/panel_cholinv.cu`` runs, or the call raises.

Gradients: ``_PanelCholInv`` wraps both forwards in one
``torch.autograd.Function``.  The TPU kernel has no backward (the JAX
package differentiates its default panel path, builtin Cholesky plus
``blocked_tri_inverse``, with XLA), so the backward here is the closed form
of Cholesky-plus-inverse, five b x b products (``torch.matmul``) and no
triangular solve, on every device:

    U_bar' = triu(U_bar - Wu^T Wu_bar Wu^T)       (Wu = U^-1)
    P      = Phi(U U_bar'^T)                      (L = U^T, L_bar = U_bar'^T)
    A_bar  = sym(Wu P Wu^T)                       (L^-T = Wu)

where Phi keeps the lower triangle with its diagonal halved and sym(X) =
(X + X^T) / 2, the symmetric gradient ``torch.linalg.cholesky`` and
``jnp.linalg.cholesky`` give.  ``_build.BACKWARDS["panel_cholinv"]`` counts
its calls.

``panel_cholinv_batched`` factors a (W, b, b) stack of panels from one C
entry (``panel_cholinv_batched_f32``: each launch's grid widened by the
panel index), the ensemble sampler's counterpart of ``jax.vmap`` over the
panel factorization; its plain version is ``plain_panel_cholinv`` on the
stack.  It is forward only.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

_T = 128


def plain_panel_cholinv(A: torch.Tensor, sub: int = 256):
    """(U, Wu) = (L^T, (L^-1)^T) of one panel or of each of a (W, b, b)
    stack, from torch.linalg.cholesky and blocked_tri_inverse; a non-SPD
    panel gives NaN, as the kernel does, in its own slice only."""
    from .blocked_cholesky import blocked_tri_inverse, cholesky

    L = cholesky(A)
    return L.mT, blocked_tri_inverse(L, sub).mT


def _launch(A: torch.Tensor):
    lib = _build.load("panel_cholinv")
    b = A.shape[0]
    U = torch.empty_like(A)
    Wu = torch.empty_like(A)
    scratch = torch.empty(b * b, dtype=A.dtype, device=A.device)  # the inverse's products
    fn = lib.panel_cholinv_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = fn(A.data_ptr(), U.data_ptr(), Wu.data_ptr(), scratch.data_ptr(), b, stream)
    _build.count_launch("panel_cholinv")
    _build.check(lib, code, "panel_cholinv kernel")
    return U, Wu


def _launch_batched(A: torch.Tensor):
    lib = _build.load("panel_cholinv")
    w, b, _ = A.shape
    U = torch.empty_like(A)
    Wu = torch.empty_like(A)
    scratch = torch.empty(w * b * b, dtype=A.dtype, device=A.device)
    fn = lib.panel_cholinv_batched_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    stream = torch.cuda.current_stream(A.device).cuda_stream
    code = fn(A.data_ptr(), U.data_ptr(), Wu.data_ptr(), scratch.data_ptr(), b, w, stream)
    _build.count_launch("panel_cholinv_batched")
    _build.check(lib, code, "panel_cholinv_batched kernel")
    return U, Wu


def panel_cholinv_backward(U, Wu, grad_U, grad_Wu):
    """A_bar of (U, Wu) = (chol(A)^T, U^-1) from the cotangents of U and Wu
    (either may be None); see the module docstring."""
    g = torch.zeros_like(U) if grad_U is None else grad_U
    if grad_Wu is not None:
        g = g - Wu.T @ grad_Wu @ Wu.T
    P = (U @ torch.triu(g).T).tril()
    P.diagonal().mul_(0.5)
    A_bar = Wu @ P @ Wu.T
    return 0.5 * (A_bar + A_bar.T)


class _PanelCholInv(torch.autograd.Function):
    """(U, Wu) of an SPD panel: the CUDA kernel for CUDA f32 tensors, the
    plain version otherwise; the closed-form backward on every device."""

    @staticmethod
    def forward(ctx, A, sub):
        if A.is_cuda and A.dtype == torch.float32:
            U, Wu = _launch(A)
        else:
            U, Wu = plain_panel_cholinv(A, sub)
        ctx.save_for_backward(U, Wu)
        return U, Wu

    @staticmethod
    def backward(ctx, grad_U, grad_Wu):
        _build.count_backward("panel_cholinv")
        U, Wu = ctx.saved_tensors
        return panel_cholinv_backward(U, Wu, grad_U, grad_Wu), None


def _check_square(A: torch.Tensor) -> None:
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"panel_cholinv needs a square matrix, got {tuple(A.shape)}")


def _check_kernel_shape(b: int) -> None:
    if b % _T != 0 or b > 1024:
        raise ValueError(
            f"pallas_panel_cholinv needs b % 128 == 0 and b <= 1024, got {b}"
        )


def _check_cuda_panel(A: torch.Tensor) -> None:
    _check_kernel_shape(A.shape[0])
    if A.dtype != torch.float32:
        raise TypeError(f"panel_cholinv kernel takes f32, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("panel_cholinv kernel needs a contiguous panel")


def panel_cholinv_function(A: torch.Tensor, sub: int = 256):
    """(U, Wu) of any square SPD panel through ``_PanelCholInv``: CUDA f32
    panels must fit the kernel (checked here, raised on); f64 CUDA panels
    and CPU panels of any size take the plain version in their dtype."""
    _check_square(A)
    if A.is_cuda and A.dtype == torch.float32:
        _check_cuda_panel(A)
    return _PanelCholInv.apply(A, sub)


def panel_cholinv(A: torch.Tensor):
    """(U, Wu) with U^T U = A and Wu = U^-1, both upper-triangular, for a
    panel the kernel takes (b % 128 == 0, b <= 1024; f32 on CUDA).
    Differentiable."""
    _check_square(A)
    _check_kernel_shape(A.shape[0])
    if A.is_cuda:
        _check_cuda_panel(A)
    return _PanelCholInv.apply(A, 256)


def panel_cholinv_batched(A: torch.Tensor):
    """(U, Wu) of each panel of a (W, b, b) stack, with U^T U = A[w] and
    Wu = U^-1, for panels the kernel takes (b % 128 == 0, b <= 1024; f32 on
    CUDA).  CUDA tensors: one call of the batched kernel, counted as
    ``panel_cholinv_batched``, or an error; CPU tensors: the plain version.
    Forward only: a CUDA input that requires grad raises."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"panel_cholinv_batched needs a (W, b, b) stack, got {tuple(A.shape)}")
    _check_kernel_shape(A.shape[1])
    if not A.is_cuda:
        return plain_panel_cholinv(A)
    if A.dtype != torch.float32:
        raise TypeError(f"panel_cholinv_batched kernel takes f32, got {A.dtype}")
    if not A.is_contiguous():
        raise ValueError("panel_cholinv_batched kernel needs a contiguous stack")
    if torch.is_grad_enabled() and A.requires_grad:
        raise RuntimeError("panel_cholinv_batched is forward only: the input requires grad")
    return _launch_batched(A)
