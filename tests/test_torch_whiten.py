"""A marginal prediction's explained variance, ||L^-1 k||^2 by column: the
plain form, the whitening kernel's arithmetic in plain PyTorch and the
routing on the CPU, the kernel itself on the GPU.

The CPU tests hold ``plain_explained_variance`` (one triangular solve) and
``split_explained_variance`` (the kernel's blocked loop, each product in
3xTF32) against f64 diag(k^T K^-1 k), and a marginal prediction through a
``CholeskyFactor``, a ``DirectInverse`` and a ``BlockSymmetric`` against
the variance of two solves at f64.  The tests marked ``cuda`` need an
NVIDIA GPU and nvcc and skip without one; this file imports no JAX, so on
the GPU machine run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_whiten.py
"""

import math

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch import _build
from albatross_tpu_torch.ops import linalg
from albatross_tpu_torch.ops.block import BlockSymmetric
from albatross_tpu_torch.ops.linalg import CholeskyFactor, DirectInverse
from albatross_tpu_torch.ops.whiten import (
    diagonal_blocks,
    plain_explained_variance,
    split_explained_variance,
    whiten_sumsq,
)

torch.set_num_threads(2)

# (n, m, b): one panel; several panels of 128 with an m that is no multiple
# of 128; panels of 256; a single column
SHAPES = [(256, 128, 256), (512, 200, 128), (768, 300, 256), (384, 1, 128)]


def _spd(n, seed, device="cpu"):
    """A seeded SPD matrix with condition number about 1e3, f64."""
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn((n, n), generator=g, dtype=torch.float64))
    return ((q * torch.logspace(-3, 0, n, dtype=torch.float64)) @ q.T).to(device)


def _explained_f64(K, k):
    return torch.sum(torch.linalg.solve(K, k) * k, dim=0)


def _rel(got, ref):
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("n, m, b", SHAPES)
def test_plain_and_split_forms_match_f64(n, m, b):
    """The plain form in f64 is diag(k^T K^-1 k) to rounding; in f32 (one
    f32 solve) and the split form (the kernel's products in 3xTF32 on the
    same f32 factor) are within a few times the f32 solve's own error."""
    K = _spd(n, seed=n + m)
    k = torch.randn((n, m), generator=torch.Generator().manual_seed(m), dtype=torch.float64)
    ref = _explained_f64(K, k)
    L = torch.linalg.cholesky(K)
    assert _rel(plain_explained_variance(L, k), ref) <= 1e-12
    L32, k32 = L.float(), k.float()
    on_f32 = torch.sum(torch.linalg.solve_triangular(L32.double(), k32.double(), upper=False) ** 2, dim=0)
    f32 = plain_explained_variance(L32, k32)
    split = split_explained_variance(L32, k32, b)
    assert split.shape == (m,) and split.dtype == torch.float32
    assert _rel(split, on_f32) <= max(4 * _rel(f32, on_f32), 1e-6)
    assert _rel(split, ref) <= 1e-3  # the f32 factor's own rounding, kappa ~ 1e3


def test_split_form_is_as_accurate_as_an_f32_solve():
    """On the benchmark model's ill-conditioned f32 factor (n = 4096, panels
    of 1024) the kernel's loop, whose diagonal solves go through the blocks'
    inverses refined once by their residuals, stays within twice the error
    of one f32 triangular solve from the f64 substitution on the same
    factor (without the refinement it reads about five times)."""
    n, m = 4096, 128
    rng = np.random.default_rng(0)
    x = torch.as_tensor(((np.arange(n) + rng.uniform(0.1, 0.9, n)) * (100.0 / n)).astype(np.float32))
    xs = torch.as_tensor(rng.uniform(0, 100, m).astype(np.float32))

    def se(a, c):
        return torch.exp(-0.5 * ((a[:, None] - c[None, :]) / 0.5) ** 2)

    L = torch.linalg.cholesky(se(x, x) + (0.09 + 1e-4) * torch.eye(n))
    cross = se(x, xs)
    ref = torch.sum(torch.linalg.solve_triangular(L.double(), cross.double(), upper=False) ** 2, dim=0)
    assert _rel(split_explained_variance(L, cross, 1024), ref) <= 2 * _rel(plain_explained_variance(L, cross), ref)


def test_diagonal_inverses_are_the_blocks_inverses():
    """diagonal_blocks gives L's diagonal blocks, zero above their
    diagonals, and their inverses."""
    L = torch.linalg.cholesky(_spd(512, seed=1))
    L_upper = L + torch.triu(torch.ones_like(L), diagonal=1)  # the kernel never reads above the diagonal
    D, W = diagonal_blocks(L_upper, 128)
    assert D.shape == W.shape == (4, 128, 128)
    for k in range(4):
        block = L[k * 128:(k + 1) * 128, k * 128:(k + 1) * 128]
        assert torch.equal(D[k], block)
        torch.testing.assert_close(W[k] @ block, torch.eye(128, dtype=torch.float64), rtol=0, atol=1e-10)
        assert torch.equal(W[k], torch.tril(W[k]))


def _gp(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    data = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), device="cpu")
    return pt.gp_from_covariance(kernel, jitter=1e-4), data


@pytest.mark.parametrize("representation, n", [("cholesky", 300), ("cholesky", 2304), ("direct_inverse", 300),
                                                ("block_symmetric", 300)])
def test_marginal_prediction_equals_two_solves_at_f64(representation, n):
    """The variance through each training covariance equals prior -
    colsum(solve(k) o k), the two-solve form, at f64; a CholeskyFactor takes
    explained_variance (one solve), the other forms keep their solve."""
    model, data = _gp(n, seed=n)
    fit = model.fit(data)
    if representation == "direct_inverse":
        fit = fit.for_serving()
    elif representation == "block_symmetric":
        fit = model.fit(data[np.arange(n - 50)]).update(data[np.arange(n - 50, n)])
    cov = fit.fit.train_covariance
    assert type(cov) is {"cholesky": CholeskyFactor, "direct_inverse": DirectInverse,
                         "block_symmetric": BlockSymmetric}[representation]
    xs = torch.linspace(0.0, 100.0, 77, dtype=torch.float64)
    cross = model._cross(fit.fit, xs)
    solve = CholeskyFactor.solve if representation == "cholesky" else type(cov).solve
    two_solves = model.covariance_function.diag(xs) - torch.sum(solve(cov, cross) * cross, dim=0)
    got = fit.predict(xs).marginal().variance
    assert float(two_solves.min()) > 0
    if representation == "cholesky":
        torch.testing.assert_close(got, two_solves, rtol=1e-9, atol=1e-12)
    else:
        assert torch.equal(got, two_solves)


def test_cpu_and_f64_take_the_plain_form(monkeypatch):
    """CPU tensors (f32 or f64) never reach the kernel's wrapper: the plain
    form, to the bit."""
    def refuse(*args):
        raise AssertionError("the kernel's wrapper was called")

    monkeypatch.setattr(linalg, "whiten_sumsq", refuse)
    L = torch.linalg.cholesky(_spd(2304, seed=2))
    k = torch.randn((2304, 64), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    for dtype in (torch.float64, torch.float32):
        chol = CholeskyFactor(L.to(dtype))
        assert not linalg._on_whiten_kernel(chol.L, k.to(dtype))
        assert torch.equal(chol.explained_variance(k.to(dtype)), plain_explained_variance(chol.L, k.to(dtype)))


def test_the_wrapper_refuses_cpu_tensors():
    L = torch.linalg.cholesky(_spd(256, seed=4)).float()
    with pytest.raises(TypeError, match="CUDA f32"):
        whiten_sumsq(L, torch.ones((256, 8)))


# -- on the GPU -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _bench_gp(n, seed, dtype=torch.float32):
    """The benchmark's exact_se1d model on n sorted points on [0, 100], on
    the card."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    return pt.gp_from_covariance(kernel, jitter=1e-4), pt.RegressionDataset.create(x, y, device="cuda", dtype=dtype)


def _factor_and_cross(n, m, seed):
    """The f32 factor of the benchmark model's training covariance and its
    (n, m) cross covariance at seeded points."""
    model, data = _bench_gp(n, seed)
    fit = model.fit(data)
    xs = torch.rand(m, generator=torch.Generator().manual_seed(seed), dtype=torch.float64) * 100
    xs = xs.to(device="cuda", dtype=torch.float32)
    return fit.fit.train_covariance.L, model._cross(fit.fit, xs)


@pytest.mark.cuda
@pytest.mark.parametrize("n, m", [(28672, 4096), (4096, 1000)])
def test_kernel_matches_f64(cuda, n, m):
    """On the f32 factor of the benchmark model: the kernel against the
    substitution in f64 on the same factor, within 3 times the error of the
    plain one-solve form (cuBLAS's f32 trsm), and against its split-product
    plain version (the same 3xTF32 products, summed by round-to-nearest);
    4 P - 1 launches."""
    L, cross = _factor_and_cross(n, m, seed=n + m)
    ref = torch.sum(torch.linalg.solve_triangular(L.double(), cross.double(), upper=False) ** 2, dim=0)
    _build.reset_launch_counts()
    got = whiten_sumsq(L, cross)
    P = n // 1024
    assert _build.LAUNCHES["whiten_sumsq"] == 4 * P - 1 and sum(_build.LAUNCHES.values()) == 4 * P - 1
    split = split_explained_variance(L, cross, 1024)
    print(f"n={n} m={m}: kernel {_rel(got, ref):.3e}, plain f32 {_rel(plain_explained_variance(L, cross), ref):.3e}, "
          f"split {_rel(split, ref):.3e}")
    assert _rel(got, ref) <= 3 * _rel(plain_explained_variance(L, cross), ref)
    assert _rel(got, split.double()) <= 1e-5


@pytest.mark.cuda
def test_kernel_is_bit_equal_across_runs(cuda):
    """Each sum of squares comes from fixed tiles in a fixed order: no
    atomics, no split-K; the caller's tensors are not written."""
    L, cross = _factor_and_cross(8192, 777, seed=5)
    L0, cross0 = L.clone(), cross.clone()
    first = whiten_sumsq(L, cross)
    assert torch.equal(first, whiten_sumsq(L, cross))
    assert torch.equal(L, L0) and torch.equal(cross, cross0)


@pytest.mark.cuda
def test_kernel_raises_on_shapes_it_does_not_take(cuda):
    L = torch.linalg.cholesky(_spd(2304, seed=6, device=cuda)).float().contiguous()  # the library's is column-major
    cross = torch.randn((2304, 16), device=cuda)
    with pytest.raises(ValueError, match="n % 128"):
        whiten_sumsq(L[:2300, :2300].contiguous(), cross[:2300])
    with pytest.raises(ValueError, match="n % 128"):
        whiten_sumsq(L, cross[:2176])
    with pytest.raises(ValueError, match="m > 0"):
        whiten_sumsq(L, cross[:, :0])
    with pytest.raises(ValueError, match="contiguous"):
        whiten_sumsq(L.T, cross)
    with pytest.raises(TypeError, match="CUDA f32"):
        whiten_sumsq(L.double(), cross.double())


@pytest.mark.cuda
def test_marginal_prediction_at_the_benchmark_shape_runs_on_the_kernel(cuda, monkeypatch):
    """28672 training points, 4096 predictions: the variance takes the
    kernel's 111 launches, and the only triangular solve is the batched one
    of the 28 diagonal blocks' inverses (none against the (n, n) factor);
    mean and variance within the benchmark's limits (3e-4, 5e-3 of the
    largest entry) of the same model in f64 on the card."""
    model, data = _bench_gp(28672, seed=22)
    fit = model.fit(data)
    xs = torch.linspace(0.0, 100.0, 4096, device=cuda)
    solves = []
    real = torch.linalg.solve_triangular

    def recorded(A, B, **kwargs):
        solves.append(tuple(A.shape))
        return real(A, B, **kwargs)

    monkeypatch.setattr(torch.linalg, "solve_triangular", recorded)
    _build.reset_launch_counts()
    pred = fit.predict(xs).marginal()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["whiten_sumsq"] == 111
    assert solves == [(28, 1024, 1024)]
    monkeypatch.undo()
    model64, data64 = _bench_gp(28672, seed=22, dtype=torch.float64)
    ref = model64.fit(data64).predict(xs.double()).marginal()
    assert _rel(pred.mean, ref.mean) <= 3e-4
    assert _rel(pred.variance, ref.variance) <= 5e-3


@pytest.mark.cuda
def test_f64_served_and_differentiated_fits_take_no_launch(cuda):
    """An f64 fit, a ``for_serving()`` fit (a DirectInverse) and a
    prediction whose gradient is asked for keep the library solves."""
    model, data = _bench_gp(4096, seed=23)
    xs = torch.linspace(0.0, 100.0, 256, device=cuda)
    model64, data64 = _bench_gp(4096, seed=23, dtype=torch.float64)
    fit64 = model64.fit(data64)
    served = model.fit(data).for_serving()
    _build.reset_launch_counts()
    fit64.predict(xs.double()).marginal()
    served.predict(xs).marginal()
    x = xs.clone().requires_grad_(True)
    variance = model.fit(data).predict(x).marginal().variance
    (grad,) = torch.autograd.grad(variance.sum(), x)
    torch.cuda.synchronize()
    assert math.isfinite(grad.abs().sum().item())
    assert _build.LAUNCHES["whiten_sumsq"] == 0
