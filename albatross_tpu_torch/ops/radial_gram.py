"""Fused radial gram: the CUDA tile kernel and its plain PyTorch version.

Counterpart of ``albatross_tpu.ops.pallas_gram``.  ``radial_gram`` is the
one entry point: on CPU tensors it evaluates the closed form
(``plain_radial_gram``, the JAX package's ``_xla_reference_gram`` plus the
diagonal); on CUDA tensors it launches ``csrc/radial_gram.cu`` or raises.
With ``diag_add`` the kernel adds noise / target variance / jitter along
the global diagonal in the same pass (the JAX package's
``_gram_diag_kernel``); without it, it is ``_gram_kernel``.

Gradients: when an input requires grad, the CUDA forward is wrapped in a
``torch.autograd.Function`` whose backward differentiates the plain closed
form, as the JAX package's custom VJP differentiates its XLA closed form.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..kernels.distances import as_matrix

PROFILES = ("squared_exponential", "exponential", "matern_32", "matern_52")
_PROFILE_ID = {p: i for i, p in enumerate(PROFILES)}
_MAX_ROW_TILES = 65535  # CUDA grid.y limit; rows are tiled by 32
_TILE = 32
# bound on the plain version's (rows, M, D) difference tensor
_PLAIN_CHUNK_ELEMENTS = 1 << 25


def apply_profile(profile: str, d2, length_scale, sigma):
    """Radial profile on squared distances (d^2 avoids sqrt where possible)."""
    s2 = sigma * sigma
    if profile == "squared_exponential":
        return s2 * torch.exp(-d2 / (length_scale * length_scale))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    scaled = d / length_scale
    if profile == "exponential":
        return s2 * torch.exp(-scaled)
    if profile == "matern_32":
        sqrt3 = math.sqrt(3.0) * scaled
        return s2 * (1.0 + sqrt3) * torch.exp(-sqrt3)
    if profile == "matern_52":
        sqrt5 = math.sqrt(5.0) * scaled
        return s2 * (1.0 + sqrt5 + sqrt5 * sqrt5 / 3.0) * torch.exp(-sqrt5)
    raise ValueError(f"unknown profile {profile}")


def plain_radial_gram(X, Y, length_scale, sigma, profile: str, diag_add=None):
    """Closed-form gram (+ diagonal): the kernel's plain version.

    Squared distances are exact elementwise sums at every D, as in the
    kernel (the JAX package's closed form switches to the cancelling
    |x|^2 + |y|^2 - 2 x.y form above D = 8, which its Pallas kernel then
    refines back to exact inside the profile's support).  Rows go in chunks
    so the (rows, M, D) difference tensor stays bounded."""
    X, Y = as_matrix(X), as_matrix(Y)
    d = X.shape[-1]
    if d == 1:
        diff = X - Y.T
        d2 = diff * diff
    else:
        rows = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, Y.shape[0] * d))
        parts = []
        for i0 in range(0, X.shape[0], rows):
            diff = X[i0:i0 + rows, None, :] - Y[None, :, :]
            parts.append(torch.sum(diff * diff, dim=-1))
        d2 = torch.cat(parts) if len(parts) > 1 else parts[0]
    out = apply_profile(profile, d2, length_scale, sigma)
    if diag_add is not None:
        out.diagonal().add_(diag_add.to(out.dtype))  # in place: no N x N temporary
    return out


def _launch(X, Y, length_scale: float, sigma: float, diag, profile: str):
    lib = _build.load("radial_gram")
    n, d = X.shape
    m = Y.shape[0]
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    if X.dtype == torch.float32:
        fn, scalar = lib.radial_gram_f32, ctypes.c_float
    else:
        fn, scalar = lib.radial_gram_f64, ctypes.c_double
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, scalar, scalar,
        ctypes.c_int, ctypes.c_void_p,
    ]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    code = fn(
        X.data_ptr(), Y.data_ptr(), None if diag is None else diag.data_ptr(),
        out.data_ptr(), n, m, d, length_scale, sigma, _PROFILE_ID[profile], stream,
    )
    _build.count_launch("radial_gram" if diag is None else "radial_gram_diag")
    _build.check(lib, code, "radial_gram kernel")
    return out


class _RadialGramFunction(torch.autograd.Function):
    """CUDA-kernel forward, closed-form backward.  The scalars come twice:
    as tensors for the backward, and as host floats for the launch, so the
    forward reads nothing back from the device."""

    @staticmethod
    def forward(ctx, X, Y, length_scale, sigma, diag, profile, ls_value, sigma_value):
        ctx.profile = profile
        ctx.save_for_backward(X, Y, length_scale, sigma, diag)
        return _launch(X, Y, ls_value, sigma_value, diag, profile)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t, need in zip(inputs, ctx.needs_input_grad) if need and t is not None]
        with torch.enable_grad():
            out = plain_radial_gram(inputs[0], inputs[1], inputs[2], inputs[3],
                                    ctx.profile, inputs[4])
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
        result = [next(grads) if need and t is not None else None
                  for t, need in zip(inputs, ctx.needs_input_grad)]
        return (*result, None, None, None)


def _check_cuda_inputs(X, Y, diag):
    if not (X.is_cuda and Y.is_cuda):
        raise ValueError(f"radial_gram: X on {X.device} and Y on {Y.device}; both must be on one device")
    if X.device != Y.device:
        raise ValueError(f"radial_gram: X on {X.device}, Y on {Y.device}")
    if X.dtype not in (torch.float32, torch.float64) or Y.dtype != X.dtype:
        raise TypeError(f"radial_gram kernel takes f32 or f64 X and Y of one dtype, got {X.dtype}/{Y.dtype}")
    if X.shape[1] != Y.shape[1]:
        raise ValueError(f"radial_gram: feature dims differ ({X.shape[1]} vs {Y.shape[1]})")
    if not (X.is_contiguous() and Y.is_contiguous()):
        raise ValueError("radial_gram kernel needs contiguous X and Y")
    if -(-X.shape[0] // _TILE) > _MAX_ROW_TILES:
        raise ValueError(f"radial_gram kernel takes at most {_MAX_ROW_TILES * _TILE} rows of X")
    if diag is not None:
        if diag.device != X.device or diag.dtype != X.dtype or diag.shape != (X.shape[0],):
            raise ValueError("radial_gram: diag_add must be an (N,) tensor of X's dtype and device")
        if not diag.is_contiguous():
            raise ValueError("radial_gram kernel needs a contiguous diag_add")
        if Y.shape[0] != X.shape[0]:
            raise ValueError("radial_gram: diag_add needs a square gram")


def radial_gram(X, Y, length_scale, sigma, profile: str = "squared_exponential", diag_add=None):
    """(N, M) radial gram sigma^2 * profile(||x_i - y_j|| / length_scale),
    plus ``diag_add`` (N,) along the diagonal when given (square case).

    CPU tensors: the closed form.  CUDA tensors: the hand-written kernel, or
    an error -- never a fallback."""
    if profile not in _PROFILE_ID:
        raise ValueError(f"unknown profile {profile}")
    X, Y = as_matrix(X), as_matrix(Y)
    if not (X.is_cuda or Y.is_cuda):
        return plain_radial_gram(X, Y, length_scale, sigma, profile, diag_add)
    _check_cuda_inputs(X, Y, diag_add)
    ls_value, sigma_value = (float(v.detach()) if isinstance(v, torch.Tensor) else float(v)
                             for v in (length_scale, sigma))
    inputs = (X, Y, length_scale, sigma, diag_add)
    if not (torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)):
        return _launch(X, Y, ls_value, sigma_value, diag_add, profile)
    ls = torch.as_tensor(length_scale, dtype=X.dtype, device=X.device)
    sg = torch.as_tensor(sigma, dtype=X.dtype, device=X.device)
    return _RadialGramFunction.apply(X, Y, ls, sg, diag_add, profile, ls_value, sigma_value)


def match_fused_training_cov(kernel, for_measurements: bool = True):
    """Pattern-match ``one Euclidean radial term + diagonal-only noise``.

    Returns (radial_leaf, length_scale, sigma, diag_scalar) or None.
    Recognized diagonal terms: IndependentNoise / Nugget with
    ``assume_unique`` (an equality mask would need the N^2 comparison the
    fusion avoids), each optionally inside measurement_only -- live only
    when ``for_measurements``."""
    from ..kernels.base import SumKernel
    from ..kernels.distances import EuclideanDistance
    from ..kernels.measurement import MeasurementOnly
    from ..kernels.noise import _EqualityNoise
    from ..kernels.radial import _RadialKernel

    terms = []

    def flatten(node):
        if isinstance(node, SumKernel):
            flatten(node.lhs)
            flatten(node.rhs)
        else:
            terms.append(node)

    flatten(kernel)
    radial = None
    diag_scalar = 0.0
    for term in terms:
        live = True
        if isinstance(term, MeasurementOnly):
            live = for_measurements
            term = term.sub
        if isinstance(term, _RadialKernel):
            if radial is not None or not live:
                return None
            if not isinstance(term.distance_metric, EuclideanDistance):
                return None
            radial = term
        elif isinstance(term, _EqualityNoise):
            if not term.assume_unique:
                return None
            if live:
                diag_scalar = diag_scalar + term._sigma2()
        else:
            return None
    if radial is None:
        return None
    ls, sigma = radial._params_values()
    return radial, ls, sigma, diag_scalar


def fused_training_covariance(kernel, X, target_variance=None, jitter: float = 0.0):
    """K + noise*I + diag(target_variance) + jitter*I in one gram pass, or
    None when the kernel or batch does not qualify."""
    matched = match_fused_training_cov(kernel, for_measurements=True)
    if matched is None or not isinstance(X, torch.Tensor) or X.ndim > 2:
        return None
    radial, ls, sigma, diag_scalar = matched
    diag = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device) + diag_scalar
    diag = diag + jitter
    if target_variance is not None:
        diag = diag + target_variance
    if float(ls) <= 0.0:
        return torch.diag(diag)  # the closed forms' length_scale > 0 guard
    return radial_gram(X, X, ls, sigma, radial._profile_name, diag_add=diag)
