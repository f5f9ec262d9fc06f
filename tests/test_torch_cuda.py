"""The hand-written CUDA kernels of albatross_tpu_torch, on the GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips without one.  On
the GPU machine run (the repository's conftest imports JAX, which the port
does not need there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs.
"""

import math

import numpy as np
import pytest
import torch

import albatross_tpu_torch as pt
from albatross_tpu_torch import _build
from albatross_tpu_torch.ops.blocked_cholesky import blocked_cholesky_cols
from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv
from albatross_tpu_torch.ops.radial_gram import PROFILES, plain_radial_gram, radial_gram

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_kernel_matches_plain(cuda, profile, d, dtype):
    g = torch.Generator().manual_seed(d)
    X = (20.0 * torch.rand((300, d), generator=g, dtype=torch.float64)).to(cuda, dtype)
    Y = (20.0 * torch.rand((141, d), generator=g, dtype=torch.float64)).to(cuda, dtype)
    diag = torch.rand(300, generator=g, dtype=torch.float64).to(cuda, dtype)
    # f64 plain reference of the same inputs
    ref = plain_radial_gram(X.double(), Y.double(), 4.0, 1.5, profile)
    got = radial_gram(X, Y, 4.0, 1.5, profile)
    atol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(got.double(), ref, rtol=0, atol=atol)
    K = radial_gram(X, X, 4.0, 1.5, profile, diag_add=diag)
    assert torch.equal(K, K.T)
    s = torch.tensor(1.5, dtype=dtype, device=cuda)
    assert torch.equal(K.diagonal(), s * s + diag)
    ref_diag = plain_radial_gram(X.double(), X.double(), 4.0, 1.5, profile, diag.double())
    torch.testing.assert_close(K.double(), ref_diag, rtol=0, atol=atol)


def test_gram_kernel_counts_and_gradients(cuda):
    _build.reset_launch_counts()
    X = torch.linspace(0, 10, 200, dtype=torch.float64, device=cuda)[:, None]
    ls = torch.tensor(1.3, dtype=torch.float64, device=cuda, requires_grad=True)
    K = radial_gram(X, X, ls, 2.0, "matern_52")
    assert _build.LAUNCHES["radial_gram"] == 1
    (g,) = torch.autograd.grad((K * K.cos()).sum(), ls)
    ls2 = ls.detach().clone().requires_grad_(True)
    K2 = plain_radial_gram(X, X, ls2, 2.0, "matern_52")
    (g2,) = torch.autograd.grad((K2 * K2.cos()).sum(), ls2)
    torch.testing.assert_close(g, g2, rtol=1e-10, atol=0)
    assert _build.LAUNCHES["radial_gram"] == 1  # the backward is the closed form


def test_gram_kernel_rejects_bad_inputs(cuda):
    X = torch.zeros((8, 2), device=cuda)
    with pytest.raises(ValueError):
        radial_gram(X, X.cpu(), 1.0, 1.0)
    with pytest.raises(TypeError):
        radial_gram(X.half(), X.half(), 1.0, 1.0)
    with pytest.raises(ValueError):
        radial_gram(X.T, X.T, 1.0, 1.0)


@pytest.mark.parametrize("b", [128, 256, 512, 1024])
def test_panel_kernel_matches_f64(cuda, b):
    g = torch.Generator().manual_seed(b)
    M = torch.randn((b, b), generator=g, dtype=torch.float64)
    A = (M @ M.T + b * torch.eye(b, dtype=torch.float64)).float().to(cuda)
    U, Wu = panel_cholinv(A)
    L = torch.linalg.cholesky(A.double())
    W = torch.linalg.inv(L)
    assert (U.T.double() - L).abs().max() / L.abs().max() < 1e-5
    assert (Wu.T.double() - W).abs().max() / W.abs().max() < 1e-4
    assert torch.equal(torch.tril(U, -1), torch.zeros_like(U))
    assert torch.equal(torch.tril(Wu, -1), torch.zeros_like(Wu))


def test_panel_kernel_guards_and_nan(cuda):
    with pytest.raises(ValueError, match="b % 128"):
        panel_cholinv(torch.eye(100, device=cuda))
    with pytest.raises(ValueError, match="b % 128"):
        panel_cholinv(torch.eye(1152, device=cuda))
    with pytest.raises(TypeError):
        panel_cholinv(torch.eye(128, dtype=torch.float64, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        panel_cholinv(torch.eye(128, device=cuda).requires_grad_(True))
    A = torch.eye(256, device=cuda)
    A[3, 3] = -1.0
    U, _ = panel_cholinv(A)
    assert torch.isnan(U).any()


def test_blocked_cholesky_on_cuda(cuda):
    g = torch.Generator().manual_seed(0)
    n = 2304  # cuda_block_size -> 768, three panels
    M = torch.randn((n, n), generator=g, dtype=torch.float64)
    K = (M @ M.T / n + torch.eye(n, dtype=torch.float64)).float().to(cuda)
    y = torch.randn(n, generator=g).to(cuda)
    _build.reset_launch_counts()
    diag, z = blocked_cholesky_cols(K, rhs=y, assemble=False)
    assert _build.LAUNCHES["panel_cholinv"] == 3
    L = torch.linalg.cholesky(K.double())
    torch.testing.assert_close(diag.double(), L.diagonal(), rtol=1e-5, atol=0)
    z_ref = torch.linalg.solve_triangular(L, y.double()[:, None], upper=False)[:, 0]
    assert (z.double() - z_ref).abs().max() / z_ref.abs().max() < 1e-4


def test_gp_on_cuda_matches_cpu_f64(cuda):
    rng = np.random.default_rng(1)
    n = 2560
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True)
    )
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    on_cpu = pt.RegressionDataset.create(x, y, dtype=torch.float64)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    _build.reset_launch_counts()
    ll = model.log_likelihood(on_gpu).item()
    assert _build.LAUNCHES["radial_gram_diag"] == 1
    assert _build.LAUNCHES["panel_cholinv"] == n // 640
    ll_ref = model.log_likelihood(on_cpu).item()
    # the f32 error grows with the n log terms and quadratic-form entries
    # summed, not with |NLML| (which is small here): bound it per point
    assert math.isfinite(ll) and abs(ll - ll_ref) < 1e-6 * n
    xs = np.linspace(0, 100, 333)
    got = model.fit(on_gpu).predict(torch.as_tensor(xs, dtype=torch.float32, device=cuda)).marginal()
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    assert _build.LAUNCHES["radial_gram"] >= 1
    assert (got.mean.double().cpu() - ref.mean).abs().max() < 1e-3
    assert (got.variance.double().cpu() - ref.variance).abs().max() < 1e-3
