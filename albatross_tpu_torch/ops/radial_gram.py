"""Fused radial gram: the CUDA tile kernel and its plain PyTorch version.

Counterpart of ``albatross_tpu.ops.pallas_gram``.  ``radial_gram`` is the
one entry point: on CPU tensors it evaluates the closed form
(``plain_radial_gram``, the JAX package's ``_xla_reference_gram`` plus the
diagonal); on CUDA tensors it launches ``csrc/radial_gram.cu`` or raises.
With ``diag_add`` the kernel adds noise / target variance / jitter along
the global diagonal in the same pass (the JAX package's
``_gram_diag_kernel``); without it, it is ``_gram_kernel``.
``radial_gram_cols`` is the lazy-gram loop's column producer: rows j0..N of
columns [j0, j0 + b) of the training covariance, a rectangular block whose
leading b x b block carries the diagonal (the JAX package's
``_make_gram_col_fn`` over its closed form); the same kernel, counted
apart.  ``radial_gram_diag_batched`` is the ensemble sampler's form: a
(W, N, N) stack of training covariances, one for each walker's length
scale, sigma and diagonal, read from device tensors, from one launch (the
counterpart of ``jax.vmap`` over the JAX package's ``pallas_call``, whose
kernel reads its scalars from ``params_ref``).  It is forward only.

Gradients: when an input requires grad, the CUDA forward is wrapped in a
``torch.autograd.Function`` whose backward differentiates the plain closed
form, as the JAX package's custom VJP (``_fused_bwd`` / ``_fused_diag_bwd``)
differentiates its XLA closed form: the TPU kernels have no backward kernel.
On the NLML's value+grad path the backward rebuilds the (N, N) closed form
with autograd, about five N x N temporaries at its peak.  CPU tensors take
the closed form and autograd directly.  Host-side reads of the scalars
(``host_float``) detach them first, so a parameter that requires grad is
read without a warning; the column producer takes them read once by its
caller, not once a panel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from ..core.parameters import host_float
from ..kernels.distances import as_matrix

PROFILES = ("squared_exponential", "exponential", "matern_32", "matern_52")
_PROFILE_ID = {p: i for i, p in enumerate(PROFILES)}
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


def _plain_d2(X, Y):
    """(N, M) squared distances as exact elementwise sums at every D, as in
    the kernel (the JAX package's closed form switches to the cancelling
    |x|^2 + |y|^2 - 2 x.y form above D = 8, which its Pallas kernel then
    refines back to exact inside the profile's support).  Rows go in chunks
    so the (rows, M, D) difference tensor stays bounded."""
    d = X.shape[-1]
    if d == 1:
        diff = X - Y.T
        return diff * diff
    rows = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, Y.shape[0] * d))
    parts = []
    for i0 in range(0, X.shape[0], rows):
        diff = X[i0:i0 + rows, None, :] - Y[None, :, :]
        parts.append(torch.sum(diff * diff, dim=-1))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def plain_radial_gram(X, Y, length_scale, sigma, profile: str, diag_add=None):
    """Closed-form gram (+ diagonal): the kernel's plain version."""
    X, Y = as_matrix(X), as_matrix(Y)
    out = apply_profile(profile, _plain_d2(X, Y), length_scale, sigma)
    if diag_add is not None:
        out.diagonal().add_(diag_add.to(out.dtype))  # in place: no N x N temporary
    return out


def plain_radial_gram_diag_batched(x, length_scales, sigmas, diag, profile: str):
    """The batched kernel's plain version: slice w of the (W, N, N) result
    is ``plain_radial_gram(x, x, length_scales[w], sigmas[w], profile,
    diag[w])``, from one (N, N) table of squared distances."""
    X = as_matrix(x)
    out = apply_profile(profile, _plain_d2(X, X)[None], length_scales[:, None, None],
                        sigmas[:, None, None])
    out.diagonal(dim1=-2, dim2=-1).add_(diag.to(out.dtype))
    return out


def _launch(X, Y, length_scale: float, sigma: float, diag, profile: str, counter: str):
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
    _build.count_launch(counter)
    _build.check(lib, code, "radial_gram kernel")
    return out


class _RadialGramFunction(torch.autograd.Function):
    """CUDA-kernel forward, closed-form backward.  The scalars come twice:
    as tensors for the backward, and as host floats for the launch, so the
    forward reads nothing back from the device."""

    @staticmethod
    def forward(ctx, X, Y, length_scale, sigma, diag, profile, ls_value, sigma_value, counter):
        # the inputs only, never the output: the lazy-gram loop subtracts
        # in place on it (ops/blocked_cholesky.py _TrailingUpdate)
        ctx.profile = profile
        ctx.save_for_backward(X, Y, length_scale, sigma, diag)
        return _launch(X, Y, ls_value, sigma_value, diag, profile, counter)

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
        return (*result, None, None, None, None)


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
    if diag is not None:
        # the kernel adds diag[i] where i == j: the leading diagonal of an
        # (N, M) block, min(N, M) long
        length = min(X.shape[0], Y.shape[0])
        if diag.device != X.device or diag.dtype != X.dtype or diag.shape != (length,):
            raise ValueError(f"radial_gram: diag_add must be a ({length},) tensor (min(N, M)) of X's "
                             f"dtype and device, got {tuple(diag.shape)} {diag.dtype} on {diag.device}")
        if not diag.is_contiguous():
            raise ValueError("radial_gram kernel needs a contiguous diag_add")


def _gram(X, Y, length_scale, sigma, profile, diag_add, counter, host_scalars=None):
    if not (X.is_cuda or Y.is_cuda):
        return plain_radial_gram(X, Y, length_scale, sigma, profile, diag_add)
    _check_cuda_inputs(X, Y, diag_add)
    if host_scalars is None:
        host_scalars = host_float(length_scale), host_float(sigma)
    inputs = (X, Y, length_scale, sigma, diag_add)
    if not (torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)):
        return _launch(X, Y, *host_scalars, diag_add, profile, counter)
    ls = torch.as_tensor(length_scale, dtype=X.dtype, device=X.device)
    sg = torch.as_tensor(sigma, dtype=X.dtype, device=X.device)
    return _RadialGramFunction.apply(X, Y, ls, sg, diag_add, profile, *host_scalars, counter)


def radial_gram(X, Y, length_scale, sigma, profile: str = "squared_exponential", diag_add=None):
    """(N, M) radial gram sigma^2 * profile(||x_i - y_j|| / length_scale),
    plus ``diag_add`` (min(N, M),) along the leading diagonal when given.

    CPU tensors: the closed form.  CUDA tensors: the hand-written kernel, or
    an error -- never a fallback."""
    if profile not in _PROFILE_ID:
        raise ValueError(f"unknown profile {profile}")
    X, Y = as_matrix(X), as_matrix(Y)
    counter = "radial_gram" if diag_add is None else "radial_gram_diag"
    return _gram(X, Y, length_scale, sigma, profile, diag_add, counter)


def _launch_diag_batched(X, length_scales, sigmas, diag, profile: str):
    lib = _build.load("radial_gram")
    n, d = X.shape
    w = length_scales.shape[0]
    out = torch.empty((w, n, n), dtype=X.dtype, device=X.device)
    fn = lib.radial_gram_diag_batched_f32 if X.dtype == torch.float32 else lib.radial_gram_diag_batched_f64
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    code = fn(X.data_ptr(), length_scales.data_ptr(), sigmas.data_ptr(), diag.data_ptr(), out.data_ptr(),
              n, d, w, _PROFILE_ID[profile], stream)
    _build.count_launch("radial_gram_diag_batched")
    _build.check(lib, code, "radial_gram_diag_batched kernel")
    return out


def radial_gram_diag_batched(x, length_scales, sigmas, diag, profile: str = "squared_exponential"):
    """(W, N, N) stack of training covariances over one (N,) or (N, D)
    input x: slice w is sigmas[w]^2 * profile(||x_i - x_j|| / length_scales[w])
    plus ``diag[w]`` on its diagonal.  ``length_scales`` and ``sigmas`` are
    (W,) tensors and ``diag`` a (W, N) tensor on x's device, so a batch of
    models' scalars reaches the card in one transfer and nothing is read
    back.  Each slice equals the unbatched ``radial_gram(x, x, ...,
    diag_add=diag[w])``: the same tile code, in the same order.

    CPU tensors: the closed form.  CUDA tensors: one launch of the kernel,
    counted as ``radial_gram_diag_batched``, or an error; forward only, so
    an input that requires grad raises there."""
    if profile not in _PROFILE_ID:
        raise ValueError(f"unknown profile {profile}")
    X = as_matrix(x)
    if not X.is_cuda:
        return plain_radial_gram_diag_batched(X, length_scales, sigmas, diag, profile)
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"radial_gram_diag_batched kernel takes f32 or f64, got {X.dtype}")
    w = length_scales.shape[0] if length_scales.ndim == 1 else -1
    for name, t, shape in (("length_scales", length_scales, (w,)), ("sigmas", sigmas, (w,)),
                           ("diag", diag, (w, X.shape[0]))):
        if t.shape != shape or t.dtype != X.dtype or t.device != X.device or not t.is_contiguous():
            raise ValueError(f"radial_gram_diag_batched: {name} must be a contiguous {shape} tensor of x's "
                             f"dtype and device, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if not X.is_contiguous():
        raise ValueError("radial_gram_diag_batched kernel needs a contiguous x")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (X, length_scales, sigmas, diag)):
        raise RuntimeError("radial_gram_diag_batched is forward only: an input requires grad")
    return _launch_diag_batched(X, length_scales, sigmas, diag, profile)


def radial_gram_cols(x, j0: int, b: int, length_scale, sigma, profile: str, diag_add,
                     host_scalars=None):
    """Rows j0..N of columns [j0, j0 + b) of the training covariance
    K(x, x) + diag(diag_add): the (N - j0, b) gram of x[j0:] against
    x[j0:j0 + b] with ``diag_add[j0:j0 + b]`` on its leading b x b
    diagonal.  ``diag_add`` is the whole (N,) diagonal; ``host_scalars``
    the (length scale, sigma) as host floats, read once by the caller.

    Launches the kernel on CUDA tensors, counted as ``radial_gram_cols``;
    CPU tensors take the closed form."""
    if profile not in _PROFILE_ID:
        raise ValueError(f"unknown profile {profile}")
    X = as_matrix(x)
    return _gram(X[j0:], X[j0:j0 + b], length_scale, sigma, profile, diag_add[j0:j0 + b],
                 "radial_gram_cols", host_scalars)


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


def _match_fused(kernel, X):
    """match_fused_training_cov(kernel) when X is one feature tensor the
    gram kernel takes, else None."""
    if not isinstance(X, torch.Tensor) or X.ndim > 2:
        return None
    return match_fused_training_cov(kernel, for_measurements=True)


def fused_training_covariance(kernel, X, target_variance=None, jitter: float = 0.0):
    """K + noise*I + diag(target_variance) + jitter*I in one gram pass, or
    None when the kernel or batch does not qualify."""
    matched = _match_fused(kernel, X)
    if matched is None:
        return None
    radial, ls, sigma, diag_scalar = matched
    diag = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device) + diag_scalar
    diag = diag + jitter
    if target_variance is not None:
        diag = diag + target_variance
    if host_float(ls) <= 0.0:
        return torch.diag(diag)  # the closed forms' length_scale > 0 guard
    return radial_gram(X, X, ls, sigma, radial._profile_name, diag_add=diag)


def fused_training_covariance_batched(kernels, X, jitters):
    """The (W, N, N) stack of ``fused_training_covariance(kernels[w], X,
    jitter=jitters[w])``, from one launch of the batched gram kernel: the
    kernels' length scales, sigmas and noise go to X's device in one
    transfer, and each diagonal is noise + jitter in X's dtype.  None when
    a kernel does not qualify; the kernels' radial profiles must agree."""
    matched = [_match_fused(k, X) for k in kernels]
    if any(t is None for t in matched):
        return None
    profile = matched[0][0]._profile_name
    if any(t[0]._profile_name != profile for t in matched):
        raise ValueError("fused_training_covariance_batched: the kernels' radial profiles differ")
    host = torch.tensor([[host_float(ls), host_float(sigma), host_float(noise), jitter]
                         for (_, ls, sigma, noise), jitter in zip(matched, jitters)], dtype=torch.float64)
    ls, sigma, noise, jitter = host.T.to(device=X.device, dtype=X.dtype)  # (4, W) in one transfer
    diag = (noise + jitter)[:, None].expand(len(kernels), X.shape[0]).contiguous()
    K = radial_gram_diag_batched(X, ls.contiguous(), sigma.contiguous(), diag, profile)
    for w in torch.nonzero(host[:, 0] <= 0.0)[:, 0].tolist():
        K[w] = torch.diag(diag[w])  # the length_scale > 0 guard, as above
    return K
