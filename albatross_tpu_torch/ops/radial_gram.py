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

The high-D branch: f32 inputs with D >= ``MXU_MIN_D`` (8, the TPU kernel's
``_MXU_MIN_D``) take the kernel's tensor-core form in every launch form,
counted apart (``<counter>_highd``): per 128 x 128 tile pair, a 3xTF32
contraction of centred coordinates, and an exact elementwise recompute of
any tile whose smallest d^2 lies inside the profile's support
(``_REFINE_D2_OVER_LS2``), as the JAX package's ``_gram_kernel`` does at
D >= 8 on its matrix unit.  K(x, x) -- the same tensor on both sides --
is mirrored (tiles I >= J, each written twice), so it is bitwise
symmetric; column blocks and walker slices follow the same global grid and
equal it bit for bit.  ``plain_radial_gram_tiled`` is that branch's plain
version in torch ops (the tests and ``chip_smoke.py`` hold the kernel to
it); CPU tensors keep the exact closed form at every D, and f64 keeps the
kernel's exact elementwise loop.

Gradients: when an input requires grad, the CUDA forward is wrapped in a
``torch.autograd.Function`` whose backward differentiates the plain closed
form, as the JAX package's custom VJP (``_fused_bwd`` / ``_fused_diag_bwd``)
differentiates its XLA closed form: the TPU kernels have no backward kernel.
On the NLML's value+grad path the backward rebuilds the (N, N) closed form
with autograd, about five N x N temporaries at its peak.  In the high-D
branch, when neither X nor Y requires grad, the backward launches the
kernel again in its squared-distance mode (profile id 4: the refined d^2
itself, counted as ``radial_gram_d2_highd``), a block of about 2^25
entries at a time on the global tile grid, and differentiates only the
profile on each block plus the diagonal, instead of the closed form's
chunked (rows, M, D) difference tensors; it holds no second N x N
buffer.  CPU tensors take the closed form and
autograd directly.  Host-side reads of the scalars
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
_SQUARED_DISTANCE_ID = 4  # the kernel writes the refined d^2 (the high-D backward's input)
# f32 feature count from which the kernel contracts on the tensor cores
# (the TPU kernel's _MXU_MIN_D): a constant, not a knob
MXU_MIN_D = 8
# Largest (d / ls)^2 where a profile is still above ~1e-3 sigma^2: a tile
# whose smallest d^2 is at most this times ls^2 is recomputed exactly (the
# JAX package's _REFINE_D2_OVER_LS2: SE e^{-x^2} < 1e-3 at x^2 = 7, the
# exponential at x = 6.9, the Materns decay slower)
_REFINE_D2_OVER_LS2 = {"squared_exponential": 7.0, "exponential": 48.0, "matern_32": 81.0, "matern_52": 81.0}
_TILE = 128  # the high-D branch's tile edge
# bound on the plain version's (rows, M, D) difference tensor, and on each
# block of squared distances the high-D backward launches (128 MiB in f32)
_PLAIN_CHUNK_ELEMENTS = 1 << 25
_D2_BLOCK_ELEMENTS = 1 << 25


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


def _same_tensor(X, Y) -> bool:
    """True when X and Y are one matrix (the symmetric K(x, x)): the same
    object, or views of the same memory with the same shape and strides."""
    return X is Y or (X.data_ptr() == Y.data_ptr() and X.shape == Y.shape and X.stride() == Y.stride())


def _edge_tiles(A, tile: int):
    """(tiles, tile, D) rows of A, the last tile filled by repeating A's
    last row (the JAX package's ``_pad_rows(edge=True)``: a tile's centre
    stays at its data)."""
    n = A.shape[0]
    padded = -(-n // tile) * tile
    if padded != n:
        A = torch.cat([A, A[-1:].expand(padded - n, -1)])
    return A.reshape(padded // tile, tile, A.shape[1])


def tiled_squared_distances(X, Y, length_scale, profile: str, tile: int = _TILE):
    """(d2, refined): the high-D branch's squared distances, (N, M), and
    which (row tile, column tile) pairs it recomputed exactly, a bool
    (ceil(N / tile), ceil(M / tile)) tensor on the CPU.

    The JAX package's ``_gram_kernel`` at D >= 8 in torch ops: for each
    tile pair, c = (mean of the x tile + mean of the y tile) / 2 (ragged
    tiles edge-padded), d^2 = max(|x - c|^2 + |y - c|^2 - 2 (x - c).(y - c),
    0) by a full-f32 ``torch.matmul``; a tile whose smallest d^2 (over its
    entries inside the matrix) is at most ``_REFINE_D2_OVER_LS2[profile] *
    ls^2`` is recomputed exactly by ``_plain_d2``.  K(x, x) (X and Y one
    matrix) computes the tiles I >= J, always recomputes the diagonal tiles
    and mirrors the rest, as the kernel does."""
    X, Y = as_matrix(X), as_matrix(Y)
    n, m = X.shape[0], Y.shape[0]
    symmetric = _same_tensor(X, Y)
    xt, yt = _edge_tiles(X, tile), _edge_tiles(Y, tile)
    nt, mt = xt.shape[0], yt.shape[0]
    mx, my = xt.mean(dim=1), yt.mean(dim=1)
    ls = torch.as_tensor(length_scale, dtype=X.dtype, device=X.device)
    cut = _REFINE_D2_OVER_LS2[profile] * ls * ls
    d2 = torch.empty((nt * tile, mt * tile), dtype=X.dtype, device=X.device)
    refined = torch.zeros((nt, mt), dtype=torch.bool)
    for i in range(nt):
        tiles = i + 1 if symmetric else mt
        c = 0.5 * (mx[i] + my[:tiles])
        xc = xt[i][None] - c[:, None, :]
        yc = yt[:tiles] - c[:, None, :]
        x2 = torch.sum(xc * xc, dim=-1)
        y2 = torch.sum(yc * yc, dim=-1)
        block = torch.clamp_min(x2[:, :, None] + y2[:, None, :] - 2.0 * torch.matmul(xc, yc.transpose(1, 2)), 0.0)
        inside = block[:, :min(tile, n - i * tile)].clone()
        if tiles * tile > m:
            inside[-1, :, m - (tiles - 1) * tile:] = math.inf
        refine = (torch.amin(inside, dim=(1, 2)) <= cut).cpu()
        if symmetric:
            refine[i] = True
        rows = slice(i * tile, (i + 1) * tile)
        d2[rows, :tiles * tile] = block.transpose(0, 1).reshape(tile, tiles * tile)
        for j in torch.nonzero(refine)[:, 0].tolist():
            r1, c1 = min(n, (i + 1) * tile), min(m, (j + 1) * tile)
            d2[i * tile:r1, j * tile:c1] = _plain_d2(X[i * tile:r1], Y[j * tile:c1])
        refined[i, :tiles] = refine
    if symmetric:
        upper = torch.triu(torch.ones((nt, nt), dtype=torch.bool, device=X.device), 1)
        d2 = torch.where(upper.repeat_interleave(tile, 0).repeat_interleave(tile, 1), d2.T, d2)
        refined = refined | refined.T
    return d2[:n, :m].contiguous(), refined


def plain_radial_gram_tiled(X, Y, length_scale, sigma, profile: str, diag_add=None, tile: int = _TILE):
    """The high-D branch's plain version: the profile of
    ``tiled_squared_distances`` (+ ``diag_add`` on the leading diagonal).
    Used by the tests and by ``chip_smoke.py``'s checks; the CPU path of
    ``radial_gram`` stays the exact ``plain_radial_gram``."""
    out = apply_profile(profile, tiled_squared_distances(X, Y, length_scale, profile, tile)[0], length_scale, sigma)
    if diag_add is not None:
        out.diagonal().add_(diag_add.to(out.dtype))
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


def _highd(X) -> bool:
    """f32 at D >= MXU_MIN_D: the kernel's tensor-core branch."""
    return X.dtype == torch.float32 and X.shape[1] >= MXU_MIN_D


def _sym_tiles(n: int, j0: int, b: int) -> int:
    """Lower tiles of the global 128-grid meeting rows [j0, n) x columns
    [j0, j0 + b) of K(x, x): the symmetric launch's grid, as the C code
    counts it."""
    row_tiles = -(-n // _TILE) - j0 // _TILE
    cols = (j0 + b - 1) // _TILE - j0 // _TILE + 1
    return cols * row_tiles - cols * (cols - 1) // 2


def _work(entries: int, device):
    """Device scratch for the high-D launch's list of near tiles: a counter
    and at most ``entries`` tile indices (8-byte words)."""
    return torch.empty((1 + entries,), dtype=torch.int64, device=device)


def _launch(X, Y, length_scale: float, sigma: float, diag, profile: str, counter: str, cols=None,
            squared_distance: bool = False):
    """One launch of the kernel, (N, M) out.  ``cols`` = (x, j0, b) when X
    and Y are x[j0:] and x[j0:j0 + b] (the lazy loop's column block); in the
    high-D branch the launch then follows x's global tile grid, and
    ``squared_distance`` writes the refined d^2 (diag must be None)."""
    lib = _build.load("radial_gram")
    n, d = X.shape
    m = Y.shape[0]
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    diag_ptr = None if diag is None else diag.data_ptr()
    if _highd(X):
        profile_id = _SQUARED_DISTANCE_ID if squared_distance else _PROFILE_ID[profile]
        ratio = _REFINE_D2_OVER_LS2[profile]
        scalars = [ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        if cols is not None or _same_tensor(X, Y):
            x, j0, b = cols if cols is not None else (X, 0, n)
            work = _work(_sym_tiles(x.shape[0], j0, b), X.device)
            fn = lib.radial_gram_highd_sym_f32
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                                                   *scalars]
            code = fn(x.data_ptr(), diag_ptr, out.data_ptr(), x.shape[0], d, j0, b, length_scale, sigma, ratio,
                      profile_id, work.data_ptr(), stream)
        else:
            work = _work(-(-n // _TILE) * -(-m // _TILE), X.device)
            fn = lib.radial_gram_highd_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, *scalars]
            code = fn(X.data_ptr(), Y.data_ptr(), diag_ptr, out.data_ptr(), n, m, d, length_scale, sigma, ratio,
                      profile_id, work.data_ptr(), stream)
        fn.restype = ctypes.c_int
        counter += "_highd"
    else:
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
        code = fn(X.data_ptr(), Y.data_ptr(), diag_ptr, out.data_ptr(), n, m, d, length_scale, sigma,
                  _PROFILE_ID[profile], stream)
    _build.count_launch(counter)
    _build.check(lib, code, f"{counter} kernel")
    return out


def _kernel_d2_backward(X, needs) -> bool:
    """Whether the backward differentiates the profile on the kernel's
    refined d^2 (the high-D branch, X and Y not requiring grad) rather than
    the closed form."""
    return _highd(X) and not (needs[0] or needs[1])


def d2_block_width(n: int, m: int) -> int:
    """Rows (cross form) or columns (K(x, x)) of each block of squared
    distances the high-D backward launches for an (n, m) output: a multiple
    of 128, so each block keeps the global tile grid, with at most about
    ``_D2_BLOCK_ELEMENTS`` entries."""
    return max(_TILE, _D2_BLOCK_ELEMENTS // max(1, m) // _TILE * _TILE)


def _d2_profile_grads(X, Y, grad_out, ls, sigma, ls_value: float, profile: str, cols):
    """(d ls, d sigma) of sum(grad_out * profile(d2)) over the kernel's
    refined d^2, taken a block at a time (``d2_block_width``), so the
    backward holds no second output-sized buffer: the cross form by row
    blocks of X; K(x, x) by column blocks of the global grid, rows j0..N
    (the lazy loop's column form), each weighted by its columns of
    grad_out plus, below the leading block, the mirrored rows' (d^2 is
    bitwise symmetric); a lazy column block, whose output is already one
    such block, in one launch.  Entries of ls, sigma that need no grad are
    None."""
    wanted = [t for t in (ls, sigma) if t.requires_grad]
    if not wanted:
        return None, None
    total = [torch.zeros_like(t) for t in wanted]

    def add(d2, weight):
        out = apply_profile(profile, d2, ls, sigma)
        for acc, g in zip(total, torch.autograd.grad(out, wanted, weight)):
            acc.add_(g)

    n, m = grad_out.shape
    if cols is not None:
        add(_launch(X, Y, ls_value, 1.0, None, profile, "radial_gram_d2", cols, squared_distance=True), grad_out)
    elif _same_tensor(X, Y):
        width = d2_block_width(n, n)
        for j0 in range(0, n, width):
            j1 = min(n, j0 + width)
            weight = grad_out[j0:, j0:j1].clone()
            weight[j1 - j0:] += grad_out[j0:j1, j1:].T
            add(_launch(X[j0:], X[j0:j1], ls_value, 1.0, None, profile, "radial_gram_d2", (X, j0, j1 - j0),
                        squared_distance=True), weight)
    else:
        height = d2_block_width(n, m)
        for i0 in range(0, n, height):
            add(_launch(X[i0:i0 + height], Y, ls_value, 1.0, None, profile, "radial_gram_d2",
                        squared_distance=True), grad_out[i0:i0 + height])
    grads = iter(total)
    return tuple(next(grads) if t.requires_grad else None for t in (ls, sigma))


class _RadialGramFunction(torch.autograd.Function):
    """CUDA-kernel forward, closed-form backward.  The scalars come twice:
    as tensors for the backward, and as host floats for the launch, so the
    forward reads nothing back from the device."""

    @staticmethod
    def forward(ctx, X, Y, length_scale, sigma, diag, profile, ls_value, sigma_value, counter, cols):
        # the inputs only, never the output: the lazy-gram loop subtracts
        # in place on it (ops/blocked_cholesky.py _TrailingUpdate)
        ctx.profile, ctx.ls_value, ctx.cols = profile, ls_value, cols
        ctx.save_for_backward(X, Y, length_scale, sigma, diag)
        return _launch(X, Y, ls_value, sigma_value, diag, profile, counter, cols)

    @staticmethod
    def backward(ctx, grad_out):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:5]
        inputs = [None if t is None else t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        wanted = [t for t, need in zip(inputs, needs) if need and t is not None]
        X, Y, ls, sigma, diag = inputs
        if _kernel_d2_backward(X, needs):
            # the kernel's refined d^2, block by block: only the profile is differentiated
            with torch.enable_grad():
                g_ls, g_sigma = _d2_profile_grads(X, Y, grad_out, ls, sigma, ctx.ls_value, ctx.profile, ctx.cols)
            g_diag = grad_out.diagonal().clone() if needs[4] else None
            return (None, None, g_ls, g_sigma, g_diag, None, None, None, None, None)
        with torch.enable_grad():
            out = plain_radial_gram(X, Y, ls, sigma, ctx.profile, diag)
        grads = iter(torch.autograd.grad(out, wanted, grad_out, allow_unused=True))
        result = [next(grads) if need and t is not None else None for t, need in zip(inputs, needs)]
        return (*result, None, None, None, None, None)


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


def _gram(X, Y, length_scale, sigma, profile, diag_add, counter, host_scalars=None, cols=None):
    if not (X.is_cuda or Y.is_cuda):
        return plain_radial_gram(X, Y, length_scale, sigma, profile, diag_add)
    _check_cuda_inputs(X, Y, diag_add)
    if host_scalars is None:
        host_scalars = host_float(length_scale), host_float(sigma)
    inputs = (X, Y, length_scale, sigma, diag_add)
    if not (torch.is_grad_enabled()
            and any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs)):
        return _launch(X, Y, *host_scalars, diag_add, profile, counter, cols)
    ls = torch.as_tensor(length_scale, dtype=X.dtype, device=X.device)
    sg = torch.as_tensor(sigma, dtype=X.dtype, device=X.device)
    return _RadialGramFunction.apply(X, Y, ls, sg, diag_add, profile, *host_scalars, counter, cols)


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
    stream = torch.cuda.current_stream(X.device).cuda_stream
    pointers = (X.data_ptr(), length_scales.data_ptr(), sigmas.data_ptr(), diag.data_ptr(), out.data_ptr())
    counter = "radial_gram_diag_batched"
    if _highd(X):
        work = _work(w * _sym_tiles(n, 0, n), X.device)
        fn = lib.radial_gram_highd_batched_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        code = fn(*pointers, n, d, w, _REFINE_D2_OVER_LS2[profile], _PROFILE_ID[profile], work.data_ptr(), stream)
        counter += "_highd"
    else:
        fn = lib.radial_gram_diag_batched_f32 if X.dtype == torch.float32 else lib.radial_gram_diag_batched_f64
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                               ctypes.c_void_p]
        code = fn(*pointers, n, d, w, _PROFILE_ID[profile], stream)
    _build.count_launch(counter)
    _build.check(lib, code, f"{counter} kernel")
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
    counted as ``radial_gram_diag_batched`` (``radial_gram_diag_batched_highd``
    in the high-D branch, each slice then equal to the unbatched high-D
    kernel's), or an error; forward only, so
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

    Launches the kernel on CUDA tensors, counted as ``radial_gram_cols``
    (``radial_gram_cols_highd`` in the high-D branch, whose tiles follow
    x's global grid, so the block equals those entries of the whole
    training covariance bit for bit); CPU tensors take the closed form."""
    if profile not in _PROFILE_ID:
        raise ValueError(f"unknown profile {profile}")
    X = as_matrix(x)
    return _gram(X[j0:], X[j0:j0 + b], length_scale, sigma, profile, diag_add[j0:j0 + b],
                 "radial_gram_cols", host_scalars, cols=(X, j0, b))


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
