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
from albatross_tpu_torch import _build, config
from albatross_tpu_torch.indexing import KFoldGrouper, LeaveOneOutGrouper
from albatross_tpu_torch.ops.blocked_cholesky import blocked_cholesky_cols
from albatross_tpu_torch.ops.panel_cholinv import (
    panel_cholinv,
    panel_cholinv_batched,
    plain_panel_cholinv,
)
from albatross_tpu_torch.ops.radial_gram import (
    PROFILES,
    plain_radial_gram,
    plain_radial_gram_diag_batched,
    radial_gram,
    radial_gram_cols,
    radial_gram_diag_batched,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


# (n, m): m % 4 = 1, 2, 3 and 0 with n not a multiple of the 64-row tile
# (vector stores on rows that start 16-byte aligned, scalar stores on the
# others and at the ragged edge), and a gram smaller than one 64 x 128
# tile; K(X, X) spans several tiles except there.
@pytest.mark.parametrize("shape", [(300, 141), (130, 258), (333, 4099), (200, 256), (5, 3)])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_kernel_matches_plain(cuda, profile, d, dtype, shape):
    n, m = shape
    g = torch.Generator().manual_seed(d)
    X = (20.0 * torch.rand((n, d), generator=g, dtype=torch.float64)).to(cuda, dtype)
    Y = (20.0 * torch.rand((m, d), generator=g, dtype=torch.float64)).to(cuda, dtype)
    diag = torch.rand(n, generator=g, dtype=torch.float64).to(cuda, dtype)
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


# (n, j0, b): blocks one tile high and many, widths m % 4 = 0, 1, 2, 3, and
# a last panel narrower than the rest
@pytest.mark.parametrize("shape", [(2600, 0, 1024), (2600, 2048, 552), (333, 100, 129), (700, 640, 58),
                                   (300, 17, 3)])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gram_column_block_matches_plain(cuda, profile, dtype, shape):
    """The lazy loop's launch form: rows j0.. of columns [j0, j0 + b) with
    the diagonal on the block's leading b x b diagonal, against the f64
    plain gram of the same block at the square gram's tolerances (bitwise
    against the plain gram of the same dtype for the squared exponential,
    the main path's profile), and the leading diagonal exactly
    sigma^2 + diag."""
    n, j0, b = shape
    g = torch.Generator().manual_seed(n + j0)
    x = (30.0 * torch.rand(n, generator=g, dtype=torch.float64)).to(cuda, dtype)
    diag = torch.rand(n, generator=g, dtype=torch.float64).to(cuda, dtype)
    _build.reset_launch_counts()
    col = radial_gram_cols(x, j0, b, 4.0, 1.5, profile, diag)
    assert _build.LAUNCHES["radial_gram_cols"] == 1 and _build.LAUNCHES["radial_gram_diag"] == 0
    assert col.shape == (n - j0, b)
    x64, d64 = x.double()[:, None], diag.double()
    ref = plain_radial_gram(x64[j0:], x64[j0:j0 + b], 4.0, 1.5, profile, d64[j0:j0 + b])
    atol = 1e-5 if dtype == torch.float32 else 1e-12
    torch.testing.assert_close(col.double(), ref, rtol=0, atol=atol)
    if profile == "squared_exponential":
        assert torch.equal(col, plain_radial_gram(x[j0:, None], x[j0:j0 + b, None], 4.0, 1.5, profile,
                                                  diag[j0:j0 + b]))
    s = torch.tensor(1.5, dtype=dtype, device=cuda)
    assert torch.equal(col[:b].diagonal(), s * s + diag[j0:j0 + b])


def test_gram_rejects_a_wrong_diagonal_length(cuda):
    """A diagonal is min(N, M) long; any other length raises."""
    X = torch.rand((300, 1), device=cuda)
    Y = X[:100].clone()
    radial_gram(X, Y, 1.0, 1.0, diag_add=torch.ones(100, device=cuda))  # leading diagonal
    for length in (300, 99, 101):
        with pytest.raises(ValueError, match="min"):
            radial_gram(X, Y, 1.0, 1.0, diag_add=torch.ones(length, device=cuda))
    with pytest.raises(ValueError, match="min"):
        radial_gram(X, X, 1.0, 1.0, diag_add=torch.ones(299, device=cuda))


def test_gram_kernel_rows_beyond_a_grid_dimension(cuda):
    """More rows than 65535 tiles of 32 (one grid dimension's limit): the
    kernel's one-dimensional grid of tiles takes them."""
    n = 65535 * 32 + 33
    g = torch.Generator().manual_seed(3)
    X = (50.0 * torch.rand((n, 1), generator=g)).to(cuda)
    for m in (8, 7):  # vector and scalar stores
        Y = (50.0 * torch.rand((m, 1), generator=g)).to(cuda)
        got = radial_gram(X, Y, 2.0, 1.0, "matern_52")
        ref = plain_radial_gram(X.double(), Y.double(), 2.0, 1.0, "matern_52")
        torch.testing.assert_close(got.double(), ref, rtol=0, atol=1e-5)


def test_numpy_data_lands_on_the_card(cuda):
    x = np.linspace(0.0, 1.0, 5)
    data = pt.RegressionDataset.create(x, np.sin(x))
    assert data.features.device.type == "cuda"
    assert data.targets.mean.device.type == "cuda"


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


# every panel size cuda_block_size can pick; with 3, 5, 6 and 7 tiles the
# log-depth inverse composition pairs blocks of unequal size
@pytest.mark.parametrize("b", [128, 256, 384, 512, 640, 768, 896, 1024])
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
    U, _ = panel_cholinv(torch.eye(128, device=cuda).requires_grad_(True))  # takes grad now
    assert U.requires_grad
    A = torch.eye(256, device=cuda)
    A[3, 3] = -1.0
    U, _ = panel_cholinv(A)
    assert torch.isnan(U).any()


@pytest.mark.parametrize("pivot", [370, 1000])
def test_panel_kernel_nan_in_last_sub_block(cuda, pivot):
    """A non-SPD pivot in the last 32-wide sub-panel of a non-first 128-tile
    (tile 2, and the last tile, of b = 1024): the NaN surfaces from the
    pivot on, in U and Wu, and the rows and columns before it stay finite."""
    g = torch.Generator().manual_seed(7)
    M = torch.randn((1024, 1024), generator=g, dtype=torch.float64)
    A = (M @ M.T + 1024 * torch.eye(1024, dtype=torch.float64)).float().to(cuda)
    A[pivot, pivot] = -1.0
    U, Wu = panel_cholinv(A)
    assert torch.isnan(U[pivot, pivot]) and torch.isnan(Wu[pivot, pivot])
    assert torch.isfinite(U[:pivot]).all() and torch.isfinite(Wu[:pivot, :pivot]).all()


@pytest.mark.parametrize("b", [128, 256, 1024])
def test_panel_kernel_gradient_matches_plain(cuda, b):
    """The panel Function on the card (kernel forward, closed-form
    backward) against autograd of the plain f32 version (cuSOLVER Cholesky
    + blocked_tri_inverse) on the same panel and cotangents.  Both carry
    f32 rounding of O(b^3) products of a panel with condition ~5, each about
    1e-6 from the exact gradient: 1e-4 relative to the largest entry leaves
    a wide margin and still fails a gradient that is wrong."""
    g = torch.Generator().manual_seed(b + 11)
    M = torch.randn((b, b), generator=g, dtype=torch.float64)
    A = (M @ M.T / b + torch.eye(b, dtype=torch.float64)).float().to(cuda)
    gU = torch.randn((b, b), generator=g).to(cuda)
    gW = torch.randn((b, b), generator=g).to(cuda)
    _build.reset_launch_counts()
    A1 = A.clone().requires_grad_(True)
    U, Wu = panel_cholinv(A1)
    (got,) = torch.autograd.grad((U, Wu), A1, (gU, gW))
    assert _build.LAUNCHES["panel_cholinv"] == 1 and _build.BACKWARDS["panel_cholinv"] == 1
    A2 = A.clone().requires_grad_(True)
    Up, Wp = plain_panel_cholinv(A2)
    (ref,) = torch.autograd.grad((Up, Wp), A2, (gU, gW))
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max() / ref.abs().max() < 1e-4


def _value_grad(model, data):
    x = model.get_tunable_parameters().values.clone().requires_grad_(True)
    value = -model.set_tunable_params(x).log_likelihood(data)
    (grad,) = torch.autograd.grad(value, x)
    return value.item(), grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_value_grad_on_cuda_matches_cpu_f64(cuda, dtype):
    """-log_likelihood and its gradient with respect to the tunable vector
    at n = 3072 (three panels of 1024) on the card against f64 on the CPU.
    f64: the same algorithm, 1e-9 relative as for the value.  f32: the
    value within 1e-6 per point as in test_gp_on_cuda_matches_cpu_f64, the
    gradient within 1e-4 relative to its largest entry (chip_smoke.py
    measured 1.2e-6 at n = 8192 on H100 and gates it at 1.2e-5)."""
    model, x, y = _bench_gp(3072, seed=4)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=dtype)
    _build.reset_launch_counts()
    value, grad = _value_grad(model, on_gpu)
    f32 = dtype == torch.float32
    assert _build.LAUNCHES["radial_gram_diag"] == 1
    assert _build.LAUNCHES["panel_cholinv"] == (3 if f32 else 0)  # the kernel is f32-only
    assert _build.BACKWARDS["panel_cholinv"] == 3  # the panel Function's backward, on every dtype
    value_ref, grad_ref = _value_grad(model, on_cpu)
    assert torch.isfinite(grad).all()
    err = ((grad.cpu() - grad_ref).abs().max() / grad_ref.abs().max()).item()
    if f32:
        assert abs(value - value_ref) < 1e-6 * 3072 and err < 1e-4
    else:
        assert abs(value - value_ref) <= 1e-9 * abs(value_ref) and err < 1e-9


@pytest.mark.parametrize("n", [3072, 3000])
def test_lazy_value_grad_on_cuda_matches_cpu_f64(cuda, n, monkeypatch):
    """The lazy-gram loop's value+grad on CUDA f32 (one column launch and
    one panel a panel; n = 3000 pads its last panel to 1024) against f64 on
    the CPU, with the gates of test_value_grad_on_cuda_matches_cpu_f64."""
    model, x, y = _bench_gp(n, seed=5)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    monkeypatch.setattr(config, "CHOLESKY_ALGORITHM", "right_fused")
    _build.reset_launch_counts()
    value, grad = _value_grad(model, on_gpu)
    assert _build.LAUNCHES["radial_gram_cols"] == 3 and _build.LAUNCHES["radial_gram_diag"] == 0
    assert _build.LAUNCHES["panel_cholinv"] == 3 and _build.BACKWARDS["panel_cholinv"] == 3
    value_ref, grad_ref = _value_grad(model, on_cpu)
    assert torch.isfinite(grad).all()
    err = ((grad.cpu() - grad_ref).abs().max() / grad_ref.abs().max()).item()
    assert abs(value - value_ref) < 1e-6 * n and err < 1e-4


@pytest.mark.parametrize("grouper", [LeaveOneOutGrouper(), KFoldGrouper(48)])
def test_fast_cv_on_cuda_matches_cpu_f64(cuda, grouper):
    """Fast LOO and a LOGO of 48 uniform groups (the batched path), f32 on
    CUDA against f64 on the CPU.  diag(A^-1) carries the f32 error of the
    factor times the condition number of the bench panels (~1e4): 1e-2 of
    the largest f64 entry leaves a margin and still fails a wrong path."""
    model, x, y = _bench_gp(3072, seed=6)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    got = model.cross_validate().predict(on_gpu, grouper).marginals()
    ref = model.cross_validate().predict(on_cpu, grouper).marginals()
    for a, r in ((got.means, ref.means), (got.variances, ref.variances)):
        assert a.shape == r.shape and torch.isfinite(a).all()
        assert ((a.double().cpu() - r).abs().max() / r.abs().max()).item() < 1e-2


def test_panel_kernel_on_main_path_panel(cuda):
    """A panel as the bench's NLML factors it: the SE gram of 1024 sorted
    points on [0, 100] plus noise and jitter, whose conditioning differs
    from M M^T + b I.  Held against f64 (the JAX package's bounds) and
    against the plain f32 version (chip_smoke.py's PANEL_PLAIN_TOL)."""
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.sort(rng.uniform(0.0, 100.0, 1024)))
    K64 = torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 0.5**2)
    K64 += (0.3**2 + 1e-4) * torch.eye(1024, dtype=torch.float64)
    A = K64.float().to(cuda)
    U, Wu = panel_cholinv(A)
    L = torch.linalg.cholesky(A.double())
    W = torch.linalg.inv(L)
    assert (U.T.double() - L).abs().max() / L.abs().max() < 1e-5
    assert (Wu.T.double() - W).abs().max() / W.abs().max() < 1e-4
    Up, Wp = plain_panel_cholinv(A)
    assert (U - Up).abs().max() / Up.abs().max() <= 5e-6
    assert (Wu - Wp).abs().max() / Wp.abs().max() <= 5e-6


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


def _bench_gp(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True)
    )
    return pt.gp_from_covariance(kernel, jitter=1e-4), x, y


def test_gp_f64_on_cuda_takes_the_jax_default_panel_path(cuda):
    """f64 on CUDA above n = 2048 (three panels of 1024) factors with
    torch.linalg.cholesky + blocked_tri_inverse, as the JAX package does for
    f64, and never launches the f32-only panel kernel."""
    n = 3072
    model, x, y = _bench_gp(n, seed=2)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float64)
    xs = np.linspace(0, 100, 333)
    _build.reset_launch_counts()
    ll = model.log_likelihood(on_gpu).item()
    got = model.fit(on_gpu).predict(torch.as_tensor(xs, device=cuda)).marginal()
    assert _build.LAUNCHES["panel_cholinv"] == 0
    ll_ref = model.log_likelihood(on_cpu).item()
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    assert abs(ll - ll_ref) <= 1e-9 * abs(ll_ref)
    assert (got.mean.cpu() - ref.mean).abs().max() <= 1e-9
    assert (got.variance.cpu() - ref.variance).abs().max() <= 1e-9


def test_gp_f32_on_cuda_launches_every_panel(cuda):
    n = 3072
    model, x, y = _bench_gp(n, seed=2)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    _build.reset_launch_counts()
    assert math.isfinite(model.log_likelihood(on_gpu).item())
    assert _build.LAUNCHES["panel_cholinv"] == n // 1024


def test_gp_on_cuda_matches_cpu_f64(cuda):
    rng = np.random.default_rng(1)
    n = 2560
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True)
    )
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
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


def _max_rel(got, ref):
    return ((got.double().cpu() - ref).abs().max() / ref.abs().max()).item()


def _sparse_pair(n, seed, ls, inducing, grouper=None):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(ls, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.sparse_gp_from_covariance(kernel, grouper=grouper, inducing_point_strategy=inducing)
    return (model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32),
            pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64))


def test_fitc_on_cuda_matches_cpu_f64(cuda):
    """FITC with 2304 inducing points 100 / 2303 ~ l / 2 apart (an inducing
    gram with kappa ~1e4, factored by three panels of 768): fit + predict
    launch the cross gram for K_fu, K_uu and the predict cross and the
    panel kernel three times; predictions, log_likelihood and its gradient
    (the nuggets included) against f64 on the CPU.  The f32 errors are
    about 1e-5 of the largest entry; 1e-3 fails a wrong path."""
    model, on_gpu, on_cpu = _sparse_pair(4000, 7, 0.09, pt.UniformlySpacedInducingPoints(2304))
    xs = np.linspace(0, 100, 257)
    _build.reset_launch_counts()
    got = model.fit(on_gpu).predict(torch.as_tensor(xs, dtype=torch.float32, device=cuda)).marginal()
    assert _build.LAUNCHES["radial_gram"] == 3 and _build.LAUNCHES["panel_cholinv"] == 3
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    assert _max_rel(got.mean, ref.mean) < 1e-3 and _max_rel(got.variance, ref.variance) < 1e-3
    value, grad = _value_grad(model, on_gpu)
    value_ref, grad_ref = _value_grad(model, on_cpu)
    assert grad.shape == (5,) and torch.isfinite(grad).all()
    assert abs(value - value_ref) < 1e-6 * 4000 and _max_rel(grad, grad_ref) < 1e-3


def test_pitc_on_cuda_matches_cpu_f64(cuda):
    """PITC with ragged groups floor(x / 2): one cross-gram launch a group
    plus K_fu, K_uu and the predict cross; the blocks take one batched
    library Cholesky (no panel kernel below n = 2048)."""
    def grouper(features):
        return np.floor(features.cpu().numpy() / 2.0).astype(np.int64)

    model, on_gpu, on_cpu = _sparse_pair(3000, 8, 0.5, pt.UniformlySpacedInducingPoints(256), grouper)
    groups = len(np.unique(grouper(on_cpu.features)))
    xs = np.linspace(0, 100, 129)
    _build.reset_launch_counts()
    got = model.fit(on_gpu).predict(torch.as_tensor(xs, dtype=torch.float32, device=cuda)).marginal()
    assert _build.LAUNCHES["radial_gram"] == groups + 3 and _build.LAUNCHES["panel_cholinv"] == 0
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    assert _max_rel(got.mean, ref.mean) < 1e-3 and _max_rel(got.variance, ref.variance) < 1e-3
    ll, ll_ref = model.log_likelihood(on_gpu).item(), model.log_likelihood(on_cpu).item()
    assert abs(ll - ll_ref) < 1e-6 * 3000


def test_exact_update_on_cuda_matches_cpu_f64(cuda):
    """update of a fit of 2304 points (three panels of 768) with 256 more:
    the predicted block's crosses and prior are three cross-gram launches,
    the 256 x 256 Schur complement a library Cholesky; predictions against
    the same update in f64 on the CPU and against a refit on the card."""
    from albatross_tpu_torch.ops.block import BlockSymmetric

    rng = np.random.default_rng(9)
    x = np.sort(rng.uniform(0, 100, 2560))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(2560)
    perm = rng.permutation(2560)
    model = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0) + pt.IndependentNoise(0.3, assume_unique=True),
                                  jitter=1e-4)
    xs = np.linspace(0, 100, 200)
    preds = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        first = pt.RegressionDataset.create(x[perm[:2304]], y[perm[:2304]], device=dev, dtype=dtype)
        rest = pt.RegressionDataset.create(x[perm[2304:]], y[perm[2304:]], device=dev, dtype=dtype)
        fit = model.fit(first)
        _build.reset_launch_counts()
        updated = fit.update(rest)
        if dev == "cuda":
            assert _build.LAUNCHES["radial_gram"] == 3 and _build.LAUNCHES["panel_cholinv"] == 0
            assert isinstance(updated.fit.train_covariance, BlockSymmetric) and updated.for_serving() is updated
        preds[dev] = updated.predict(torch.as_tensor(xs, dtype=dtype, device=dev)).marginal()
    full = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    refit = model.fit(full).predict(torch.as_tensor(xs, dtype=torch.float32, device=cuda)).marginal()
    got, ref = preds["cuda"], preds["cpu"]
    assert _max_rel(got.mean, ref.mean) < 1e-3 and _max_rel(got.variance, ref.variance) < 1e-3
    assert _max_rel(got.mean, refit.mean.double().cpu()) < 1e-3


def test_for_serving_on_cuda_matches_cpu_f64(cuda):
    """for_serving at n = 3072 on the card: the explicit inverse (two
    Newton-Schulz steps) predicts as the factor does in f64 on the CPU; the
    inverse's f32 error shows in the variance, a difference of two
    near-equal terms, hence its 1e-2."""
    from albatross_tpu_torch.ops.linalg import DirectInverse

    model, x, y = _bench_gp(3072, seed=10)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    xs = np.linspace(0, 100, 300)
    _build.reset_launch_counts()
    serving = model.fit(on_gpu).for_serving()
    assert isinstance(serving.fit.train_covariance, DirectInverse)
    assert _build.LAUNCHES["radial_gram_diag"] == 1 and _build.LAUNCHES["panel_cholinv"] == 3
    got = serving.predict(torch.as_tensor(xs, dtype=torch.float32, device=cuda)).marginal()
    ref = model.fit(on_cpu).predict(torch.as_tensor(xs)).marginal()
    assert _max_rel(got.mean, ref.mean) < 1e-3 and _max_rel(got.variance, ref.variance) < 1e-2


def test_safe_fit_on_cuda_matches_cpu_f64(cuda):
    """safe_factorization on 1024 points, each twice, no noise (a singular
    gram): the f32 fit on the card escalates the jitter through the library
    Cholesky (no panel kernel), and its predictions and log_likelihood are
    finite and nearer to an f64 fit at the chosen jitter on the CPU than to
    one at 100x it."""
    from albatross_tpu_torch.ops.linalg import CholeskyFactor

    rng = np.random.default_rng(11)
    x = np.repeat(np.sort(rng.uniform(0, 100, 1024)), 2)
    y = np.sin(0.3 * x)
    on_gpu = pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32)
    on_cpu = pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)
    model = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0), safe_factorization=True)
    xs = torch.linspace(0, 100, 150)
    _build.reset_launch_counts()
    got = model.fit(on_gpu).predict(xs.to(cuda)).marginal()
    ll = model.log_likelihood(on_gpu).item()
    assert _build.LAUNCHES["panel_cholinv"] == 0
    assert math.isfinite(ll) and torch.isfinite(got.mean).all() and torch.isfinite(got.variance).all()
    K = radial_gram(on_gpu.features, on_gpu.features, 0.5, 1.0, diag_add=torch.zeros(2048, device=cuda))
    jitter = CholeskyFactor.safe_jitter(K)
    assert jitter > 0

    def err(j):
        ref = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0), jitter=j).fit(on_cpu).predict(
            xs.double()).marginal()
        return _max_rel(got.mean, ref.mean)

    assert err(jitter) < 0.1 * err(100.0 * jitter)


def test_null_model_predicts_on_the_card(cuda):
    """NullModel's predictions lie where the features do, integer features
    included, and on the card for numpy features."""
    model = pt.NullModel()
    fit = model.fit(pt.RegressionDataset.create(np.asarray([1.0, 2.0]), np.asarray([3.0, 4.0])))
    for features in (torch.arange(3, device=cuda), np.asarray([5.0, 6.0, 7.0]), np.asarray([5, 6, 7])):
        pred = fit.predict(features)
        assert pred.marginal().mean.device.type == "cuda" and pred.joint().covariance.device.type == "cuda"
        assert torch.equal(pred.marginal().variance.cpu(), torch.full((3,), 1e4))


def test_temperature_model_on_cuda_matches_cpu_f64(cuda):
    """The temperature model (angular and radial metrics over station rows)
    at n = 3072: f32 on the card against f64 on the CPU, at bounds set by
    the angular metric's f32 floor (acos near 1 resolves no angle below
    ~3.5e-4 rad; on the CPU in f32 the same model is 2.3e-3 / 1.5e-3 /
    3.5e-2 off in NLML / mean / variance); f64 on the card against the CPU
    at 10x the first reading (3.7e-8 / 4.7e-8 / 4.4e-7 on H100): the same
    floor in f64, where the card's and the CPU's products round the
    diagonal dots 1 ulp apart, which moves those angles between 0 and
    1.5e-8 rad.  Only the panel kernel launches: three panels of 1024 a
    factorization."""
    from albatross_tpu_torch import temperature as tt

    n = 3072
    stations, obs, _ = tt.synthesize_stations(n, np.random.default_rng(11))
    grid = tt.sea_level_grid(16, 16)
    model = tt.build_model()
    out = {}
    for where, dtype in (("cpu", torch.float64), ("cuda", torch.float64), ("cuda", torch.float32)):
        data = pt.RegressionDataset.create(stations, obs, variance=np.ones(n), device=where, dtype=dtype)
        _build.reset_launch_counts()
        ll = model.log_likelihood(data).item()
        pred = model.fit(data).predict(torch.as_tensor(grid, dtype=dtype, device=where)).marginal()
        out[where, dtype] = ll, pred, dict(_build.LAUNCHES)
    ll_ref, ref, _ = out["cpu", torch.float64]
    for dtype, bounds in ((torch.float64, (4e-7, 5e-7, 4.4e-6)), (torch.float32, (1e-2, 1e-2, 0.2))):
        ll, pred, counts = out["cuda", dtype]
        errors = (abs(ll - ll_ref) / abs(ll_ref), _max_rel(pred.mean, ref.mean), _max_rel(pred.variance, ref.variance))
        print(f"temperature n={n} {dtype} card vs CPU f64: {errors}, launches {counts}")
        assert all(e <= b for e, b in zip(errors, bounds)), (dtype, errors)
        assert counts["radial_gram"] == 0
        assert counts["panel_cholinv"] == (6 if dtype == torch.float32 else 0)


def test_mixed_feature_model_launches_the_gram_kernel(cuda):
    """A TaggedBatch of 2240 positions and 64 bias ids: the positions'
    Euclidean block and the cross gram run the gram kernel, the
    factorization three panels of 768; f32 on the card against f64 on the
    CPU, within about 10x the first reading on H100 (5.5e-4)."""
    from albatross_tpu_torch.kernels import TaggedBatch, difference_of, for_tag

    rng = np.random.default_rng(4)
    positions = np.sort(rng.uniform(0.0, 100.0, 2240))
    tags = rng.permutation(np.repeat([0, 1], [2240, 64]))
    y = rng.standard_normal(tags.shape[0])
    kernel = (for_tag(pt.SquaredExponential(2.0, 1.5), 0) + for_tag(pt.IndependentNoise(0.7), 1)
              + pt.Constant(0.3) + pt.measurement_only(pt.IndependentNoise(0.1)))
    model = pt.gp_from_covariance(kernel)
    out = {}
    for where, dtype in (("cpu", torch.float64), ("cuda", torch.float32)):
        def t(v):
            return torch.as_tensor(v, dtype=dtype, device=where)

        batch = TaggedBatch.create(tags, {0: t(positions), 1: t(np.arange(64.0))})
        data = pt.RegressionDataset.create(batch, t(y), variance=t(np.full(y.shape[0], 0.01)))
        _build.reset_launch_counts()
        fit = model.fit(data)
        counts = dict(_build.LAUNCHES)
        pred = fit.predict(t(np.linspace(0.0, 100.0, 300))).marginal()
        diff = fit.predict(difference_of(t(positions[:50]), t(positions[50:100]))).marginal()
        out[where] = counts, dict(_build.LAUNCHES), pred, diff
    counts, total, pred, diff = out["cuda"]
    _, _, ref, ref_diff = out["cpu"]
    assert counts == {"radial_gram": 1, "radial_gram_diag": 0, "radial_gram_cols": 0, "radial_gram_diag_batched": 0,
                      "panel_cholinv": 3, "panel_cholinv_batched": 0}
    assert total["radial_gram"] == 1 + 1 + 2  # the fit, the cross gram, the differences' two grams
    errors = [_max_rel(pred.mean, ref.mean), _max_rel(pred.variance, ref.variance),
              _max_rel(diff.mean, ref_diff.mean), _max_rel(diff.variance, ref_diff.variance)]
    print(f"mixed features f32 card vs CPU f64: {errors}")
    assert max(errors) < 5e-3, errors


# the sampler's batched forms: (W, n, d) with ragged n, the staged path
# (d > 4) and one walker
@pytest.mark.parametrize("shape", [(3, 300, 1), (2, 517, 6), (1, 130, 3), (5, 64, 2)])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_gram_matches_plain_and_the_unbatched_kernel(cuda, profile, dtype, shape):
    """Each slice of the batched training covariance equals the unbatched
    kernel's output bit for bit (the same tile code) and the plain batched
    version within the gram's tolerance; one launch for the stack."""
    w, n, d = shape
    g = torch.Generator().manual_seed(n + d)
    x = (10.0 * torch.rand((n, d), generator=g, dtype=torch.float64)).to(cuda, dtype)
    ls = (0.5 + torch.rand(w, generator=g, dtype=torch.float64)).to(cuda, dtype)
    sigma = (0.5 + torch.rand(w, generator=g, dtype=torch.float64)).to(cuda, dtype)
    diag = (0.01 + torch.rand((w, n), generator=g, dtype=torch.float64)).to(cuda, dtype)
    _build.reset_launch_counts()
    K = radial_gram_diag_batched(x, ls, sigma, diag, profile)
    assert _build.LAUNCHES["radial_gram_diag_batched"] == 1 and K.shape == (w, n, n)
    atol = 1e-5 if dtype == torch.float32 else 1e-12
    ref = plain_radial_gram_diag_batched(x.double(), ls.double(), sigma.double(), diag.double(), profile)
    torch.testing.assert_close(K.double(), ref, rtol=0, atol=atol * float(sigma.max()) ** 2)
    for i in range(w):
        assert torch.equal(K[i], radial_gram(x, x, float(ls[i]), float(sigma[i]), profile, diag_add=diag[i]))
    with pytest.raises(RuntimeError, match="forward only"):
        radial_gram_diag_batched(x, ls.clone().requires_grad_(True), sigma, diag, profile)
    with pytest.raises(ValueError, match="diag"):
        radial_gram_diag_batched(x, ls, sigma, diag[:, :-1], profile)


@pytest.mark.parametrize("w, b", [(3, 128), (2, 256), (5, 640), (4, 1024)])
def test_batched_panel_matches_the_unbatched_kernel_and_isolates_nan(cuda, w, b):
    g = torch.Generator().manual_seed(b)
    M = torch.randn((w, b, b), generator=g, dtype=torch.float64)
    A = (M @ M.mT + b * torch.eye(b, dtype=torch.float64)).to(cuda, torch.float32)
    _build.reset_launch_counts()
    U, Wu = panel_cholinv_batched(A)
    assert _build.LAUNCHES["panel_cholinv_batched"] == 1 and _build.LAUNCHES["panel_cholinv"] == 0
    Up, Wp = plain_panel_cholinv(A)
    for i in range(w):
        Ui, Wi = panel_cholinv(A[i].contiguous())
        assert torch.equal(U[i], Ui) and torch.equal(Wu[i], Wi)
        assert (U[i] - Up[i]).abs().max() <= 5e-6 * Up[i].abs().max()
        assert (Wu[i] - Wp[i]).abs().max() <= 5e-6 * Wp[i].abs().max()
    A[w // 2, 5, 5] = -1.0
    U, _ = panel_cholinv_batched(A)
    assert [bool(torch.isnan(U[i]).any()) for i in range(w)] == [i == w // 2 for i in range(w)]
    with pytest.raises(TypeError, match="f32"):
        panel_cholinv_batched(A.double())
    with pytest.raises(RuntimeError, match="forward only"):
        panel_cholinv_batched(A.clone().requires_grad_(True))


@pytest.mark.parametrize("n", [300, 3072, 3000])
def test_batched_log_likelihood_on_cuda_matches_cpu_f64(cuda, n):
    """The sampler's batched log-prob, f32 and f64 on the card, against the
    per-walker f64 log_likelihood on the CPU; the fused route launches one
    batched gram, and above n = 2048 one batched panel call a panel (3072
    factors views of the stack in place, 3000 pads copies)."""
    from albatross_tpu_torch.models.gp import GaussianProcess

    rng = np.random.default_rng(n)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    x0 = model.get_tunable_parameters().values
    walkers = x0[None, :] + 0.05 * torch.as_tensor(rng.standard_normal((4, x0.shape[0])))
    models = [model.set_tunable_params(w) for w in walkers]
    cpu = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y))
    ref = torch.stack([m.log_likelihood(cpu) for m in models])
    for dtype, rtol in ((torch.float64, 1e-9), (torch.float32, 1e-4)):
        data = pt.RegressionDataset.create(x, y, device=cuda, dtype=dtype)
        _build.reset_launch_counts()
        got = GaussianProcess.batched_log_likelihood(models, data)
        assert got.device.type == "cpu" and got.dtype == torch.float64
        torch.testing.assert_close(got, ref, rtol=rtol, atol=0)
        assert _build.LAUNCHES["radial_gram_diag_batched"] == 1
        panels = -(-n // 1024) if (n > 2048 and dtype == torch.float32) else 0
        assert _build.LAUNCHES["panel_cholinv_batched"] == panels and _build.LAUNCHES["panel_cholinv"] == 0


def test_batched_log_likelihood_splits_at_the_cards_memory(cuda, monkeypatch):
    """With the card's available memory read as 2.5 walkers' worth, 4
    walkers at n = 3072 run as batches of 2: two batched gram launches, the
    same log-probs as one batch; a reading below one walker raises."""
    from albatross_tpu_torch.models.gp import GaussianProcess
    from albatross_tpu_torch.ops import batched_nlml

    rng = np.random.default_rng(9)
    n = 3072
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    x0 = model.get_tunable_parameters().values
    models = [model.set_tunable_params(x0 + 0.05 * torch.as_tensor(rng.standard_normal(x0.shape[0])))
              for _ in range(4)]
    data = pt.RegressionDataset.create(x, y, device=cuda, dtype=torch.float32)
    whole = GaussianProcess.batched_log_likelihood(models, data)
    per = batched_nlml.bytes_per_walker(n, 4, torch.device(cuda))
    monkeypatch.setattr(batched_nlml, "available_bytes", lambda device: int(2.5 * per / batched_nlml.MEMORY_SHARE))
    _build.reset_launch_counts()
    split = GaussianProcess.batched_log_likelihood(models, data)
    assert _build.LAUNCHES["radial_gram_diag_batched"] == 2
    torch.testing.assert_close(split, whole, rtol=1e-6, atol=0)
    monkeypatch.setattr(batched_nlml, "available_bytes", lambda device: per // 2)
    with pytest.raises(MemoryError, match="4 walkers at n = 3072"):
        GaussianProcess.batched_log_likelihood(models, data)


def test_sampler_chain_on_cuda(cuda):
    from albatross_tpu_torch.samplers import ensemble_sampler_from_model

    rng = np.random.default_rng(3)
    x = np.sort(rng.uniform(0, 20, 200))
    y = np.sin(x) + 0.1 * rng.standard_normal(200)
    kernel = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.1, assume_unique=True))
    data = pt.RegressionDataset.create(x, y, device=cuda, dtype=torch.float32)
    chain = ensemble_sampler_from_model(pt.gp_from_covariance(kernel, jitter=1e-5), data, 8, 5, key=2)
    assert chain.params.shape == (6, 8, 3) and np.isfinite(chain.log_prob).all()
