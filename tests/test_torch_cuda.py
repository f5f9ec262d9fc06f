"""The hand-written CUDA kernels of albatross_tpu_torch, on the GPU.

Every test here needs an NVIDIA GPU and nvcc, and skips without one.  On
the GPU machine run (the repository's conftest imports JAX, which the port
does not need there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same inputs.
"""

import importlib
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
    plain_radial_gram_tiled,
    radial_gram,
    radial_gram_cols,
    radial_gram_diag_batched,
    tiled_squared_distances,
)

pytestmark = pytest.mark.cuda
rg = importlib.import_module("albatross_tpu_torch.ops.radial_gram")


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


def _line(n, d, seed, offset=1000.0):
    """n f32 points of the 32-feature GP's law in R^d (a line through the
    offset, sorted along it, plus 0.05 noise), on the card."""
    g = torch.Generator().manual_seed(seed)
    t = torch.sort(100.0 * torch.rand(n, generator=g, dtype=torch.float64)).values
    u = torch.randn(d, generator=g, dtype=torch.float64)
    u = u / u.norm()
    return (offset + t[:, None] * u + 0.05 * torch.randn((n, d), generator=g, dtype=torch.float64)).float().cuda()


# The high-D branch (f32, D >= 8) against its plain version on the card:
# both about f32-accurate contractions (3xTF32 against torch.matmul's
# FP32), refined tiles exact in both; 1e-5 sigma^2 as the gram's f32
# tolerance above.  A tile whose minimum sits at the refinement cut may
# refine in one and not the other: the far-field error there is smaller.
HIGHD_ATOL = 1e-5


# (n, m): ragged and whole 128-tiles, rows that are not 16-byte aligned
# (m % 4 != 0, so the kernel stores without its tensor map), fewer lower
# tiles than the card's resident tile blocks (n = 128, 1000) and more
# (n = 8193: 2145 lower tiles); D across the 32-feature chunk boundary.
@pytest.mark.parametrize("shape", [(300, 141), (130, 258), (333, 4099), (200, 256), (5, 3), (128, 129),
                                   (1000, 128), (8193, 300)])
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("d", [8, 9, 31, 32, 33, 64, 100])
def test_highd_gram_matches_tiled(cuda, profile, d, shape):
    """The cross form and K(X, X) + diag at D >= 8 (f32) launch the
    tensor-core branch (counted apart) and match plain_radial_gram_tiled
    and the f64 closed form; K(X, X) is bitwise symmetric with its diagonal
    exactly sigma^2 + diag."""
    n, m = shape
    A = _line(n + m, d, seed=d + n)
    perm = torch.randperm(n + m, generator=torch.Generator().manual_seed(n)).cuda()
    X, Y = A[perm[:n].sort().values].contiguous(), A[perm[n:].sort().values].contiguous()
    diag = (0.1 + torch.rand(n, generator=torch.Generator().manual_seed(m))).cuda()
    _build.reset_launch_counts()
    got = radial_gram(X, Y, 2.0, 1.5, profile)
    K = radial_gram(X, X, 2.0, 1.5, profile, diag_add=diag)
    assert _build.LAUNCHES["radial_gram_highd"] == 1 and _build.LAUNCHES["radial_gram_diag_highd"] == 1
    assert _build.LAUNCHES["radial_gram"] == 0 and _build.LAUNCHES["radial_gram_diag"] == 0
    atol = HIGHD_ATOL * 1.5**2
    torch.testing.assert_close(got, plain_radial_gram_tiled(X, Y, 2.0, 1.5, profile), rtol=0, atol=atol)
    torch.testing.assert_close(got.double(), plain_radial_gram(X.double(), Y.double(), 2.0, 1.5, profile),
                               rtol=0, atol=atol)
    assert torch.equal(K, K.T)
    s = torch.tensor(1.5, device=cuda)
    assert torch.equal(K.diagonal(), s * s + diag)
    torch.testing.assert_close(K, plain_radial_gram_tiled(X, X, 2.0, 1.5, profile, diag), rtol=0, atol=atol)


def _lowd_cases():
    """name -> (X, Y, diag, profile): grams below D = 8, f32 and f64, cross
    and training covariance, whose outputs must keep the bits they had
    before the high-D branch."""
    cases = {}
    for d in (1, 3, 7):
        for dtype in (torch.float32, torch.float64):
            g = torch.Generator().manual_seed(11 + d)
            X = (20.0 * torch.rand((333, d), generator=g, dtype=torch.float64)).to("cuda", dtype)
            Y = (20.0 * torch.rand((141, d), generator=g, dtype=torch.float64)).to("cuda", dtype)
            diag = torch.rand(333, generator=g, dtype=torch.float64).to("cuda", dtype)
            profile = PROFILES[d % 4]
            cases[f"d{d} {str(dtype)[6:]} cross"] = (X, Y, None, profile)
            cases[f"d{d} {str(dtype)[6:]} covariance"] = (X, X, diag, profile)
    return cases


# sha256 (first 16 hex digits) of each case's output from the kernel
# before its high-D branch (commit c33de6f), on NVIDIA H100 80GB HBM3
LOWD_SHA256 = {
    "d1 float32 cross": "f1c9396af2342324", "d1 float32 covariance": "39107d3c1da125a6",
    "d1 float64 cross": "55c91e0a1342fcec", "d1 float64 covariance": "c78a84a6f0bbab6c",
    "d3 float32 cross": "f92c0759d4dd0daf", "d3 float32 covariance": "5ff1130a17c03882",
    "d3 float64 cross": "820f0cac8d2e320f", "d3 float64 covariance": "4462d21c755692b4",
    "d7 float32 cross": "a2e9dca87ee69b60", "d7 float32 covariance": "dbfb500dba498d91",
    "d7 float64 cross": "7687e2ee913649bd", "d7 float64 covariance": "1edb029284affdec",
}


def test_lowd_gram_outputs_keep_their_bits(cuda):
    """Below D = 8 the kernel keeps its code and its bits: each output of
    _lowd_cases hashes as it did before the high-D branch."""
    import hashlib

    _build.reset_launch_counts()
    for name, (X, Y, diag, profile) in _lowd_cases().items():
        out = radial_gram(X, Y, 4.0, 1.5, profile, diag_add=diag)
        assert hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16] == LOWD_SHA256[name], name
    assert sum(v for k, v in _build.LAUNCHES.items() if k.endswith("_highd")) == 0


def _elementwise_f32(X, Y, ls, sigma, profile):
    """The kernel's elementwise loop at any D: its ``radial_gram_f32`` entry,
    which the wrapper calls only below D = 8."""
    import ctypes

    lib = _build.load("radial_gram")
    out = torch.empty((X.shape[0], Y.shape[0]), device=X.device)
    fn = lib.radial_gram_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                                           ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    code = fn(X.data_ptr(), Y.data_ptr(), None, out.data_ptr(), X.shape[0], Y.shape[0], X.shape[1], ls, sigma,
              PROFILES.index(profile), torch.cuda.current_stream().cuda_stream)
    assert code == 0
    return out


@pytest.mark.parametrize("d", [9, 32, 100])
@pytest.mark.parametrize("profile", PROFILES)
def test_highd_refined_tiles_hold_the_elementwise_bits(cuda, profile, d):
    """A refined tile of the high-D branch holds the elementwise loop's
    bits (the same arithmetic in the same order), in the cross form and in
    K(X, X); the other tiles are within HIGHD_ATOL of it."""
    X, Y = _line(700, d, seed=3), _line(300, d, seed=4)
    for P, Q in ((X, Y), (X, X)):
        got = radial_gram(P, Q, 2.0, 1.5, profile)
        _, refined = tiled_squared_distances(P, Q, 2.0, profile)
        inside = refined.repeat_interleave(128, 0).repeat_interleave(128, 1)[:P.shape[0], :Q.shape[0]].cuda()
        assert inside.any() and not inside.all()
        loop = _elementwise_f32(P, Q, 2.0, 1.5, profile)
        assert torch.equal(got[inside], loop[inside])
        assert (got - loop).abs().max() <= HIGHD_ATOL * 1.5**2


@pytest.mark.parametrize("b", [512, 1024])
@pytest.mark.parametrize("d", [9, 32, 100])
def test_highd_column_blocks_equal_the_training_covariance(cuda, d, b):
    """The lazy loop's column blocks at D >= 8 follow the global 128-grid:
    each equals those entries of the materialized training covariance bit
    for bit, at every j0 of a lazy loop of width b (the last block
    ragged), and at blocks that start off the grid."""
    n = 2600
    x = _line(n, d, seed=d)
    diag = (0.01 + torch.rand(n, generator=torch.Generator().manual_seed(d))).cuda()
    K = radial_gram(x, x, 2.0, 1.5, "matern_52", diag_add=diag)
    _build.reset_launch_counts()
    blocks = [(j0, min(b, n - j0)) for j0 in range(0, n, b)] + [(100, 129), (1, 1)]
    for j0, width in blocks:
        col = radial_gram_cols(x, j0, width, 2.0, 1.5, "matern_52", diag)
        assert col.shape == (n - j0, width)
        assert torch.equal(col, K[j0:, j0:j0 + width])
    assert _build.LAUNCHES["radial_gram_cols_highd"] == len(blocks) and _build.LAUNCHES["radial_gram_cols"] == 0


@pytest.mark.parametrize("d", [8, 32, 33, 100])
def test_highd_batched_slices_equal_the_unbatched_kernel(cuda, d):
    """The walker-batched training covariance at D >= 8: one launch, each
    slice the unbatched high-D kernel's output bit for bit (the refinement
    cut from each walker's length scale) and the tiled version's within
    HIGHD_ATOL."""
    w, n = 3, 517
    x = _line(n, d, seed=d)
    g = torch.Generator().manual_seed(d)
    ls = (1.0 + 2.0 * torch.rand(w, generator=g)).cuda()
    sigma = (0.5 + torch.rand(w, generator=g)).cuda()
    diag = (0.01 + torch.rand((w, n), generator=g)).cuda()
    _build.reset_launch_counts()
    K = radial_gram_diag_batched(x, ls, sigma, diag, "squared_exponential")
    assert _build.LAUNCHES["radial_gram_diag_batched_highd"] == 1 and K.shape == (w, n, n)
    for i in range(w):
        one = radial_gram(x, x, float(ls[i]), float(sigma[i]), "squared_exponential", diag_add=diag[i])
        assert torch.equal(K[i], one)
        tiled = plain_radial_gram_tiled(x, x, float(ls[i]), float(sigma[i]), "squared_exponential", diag[i])
        torch.testing.assert_close(K[i], tiled, rtol=0, atol=HIGHD_ATOL * float(sigma[i]) ** 2)


def test_highd_backward_launches_the_squared_distance_mode(cuda):
    """value+grad at D = 32 through the public API: the fused covariance's
    backward launches the kernel once in its squared-distance mode, and
    the gradient matches the closed-form backward's (X requiring grad keeps
    that one) within 1e-4 of its largest entry."""
    x = _line(2304, 32, seed=7)
    y = torch.sin(0.3 * (x - 1000.0).sum(-1) / math.sqrt(32.0))
    kernel = pt.SquaredExponential(2.0, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    data = pt.RegressionDataset.create(x, y)
    _build.reset_launch_counts()
    p = model.get_tunable_parameters().values.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(-model.set_tunable_params(p).log_likelihood(data), p)
    assert _build.LAUNCHES["radial_gram_diag_highd"] == 1 and _build.LAUNCHES["radial_gram_d2_highd"] == 1
    xg = x.clone().requires_grad_(True)
    data_g = pt.RegressionDataset.create(xg, y)
    p = model.get_tunable_parameters().values.clone().requires_grad_(True)
    _build.reset_launch_counts()
    (g_closed, _) = torch.autograd.grad(-model.set_tunable_params(p).log_likelihood(data_g), (p, xg))
    assert _build.LAUNCHES["radial_gram_d2_highd"] == 0
    assert (g - g_closed).abs().max() <= 1e-4 * g_closed.abs().max()


@pytest.mark.parametrize("d", [9, 32, 100])
def test_highd_squared_distance_blocks_match_tiled(cuda, d):
    """The backward's squared-distance launches (profile id 4) against
    tiled_squared_distances: the column form at j0 = 0, 1024 and the
    ragged last block, and the cross form's row blocks, within 1e-6 of
    the block's largest d^2 (f32 contractions and exact sums in another
    order); and the blocked backward's gradient equal to one block's
    within 1e-5 of its largest entry."""
    n = 2600
    x, y = _line(n, d, seed=d), _line(700, d, seed=d + 1)
    for j0, b in ((0, 1024), (1024, 1024), (2048, 552)):
        got = rg._launch(x[j0:], x[j0:j0 + b], 2.0, 1.0, None, "matern_52", "radial_gram_d2", (x, j0, b),
                         squared_distance=True)
        ref = tiled_squared_distances(x[j0:], x[j0:j0 + b], 2.0, "matern_52")[0]
        assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()
    got = rg._launch(x[1024:2048], y, 2.0, 1.0, None, "matern_52", "radial_gram_d2", squared_distance=True)
    ref = tiled_squared_distances(x, y, 2.0, "matern_52")[0][1024:2048]
    assert (got - ref).abs().max() <= 1e-6 * ref.abs().max()

    g = torch.Generator().manual_seed(d)
    cot, cot_y = torch.randn((n, n), generator=g).cuda(), torch.randn((n, 700), generator=g).cuda()
    diag = torch.full((n,), 0.1, device=cuda)

    def grads():
        ls, sg = torch.tensor(2.0, device=cuda, requires_grad=True), torch.tensor(1.5, device=cuda, requires_grad=True)
        K = rg._RadialGramFunction.apply(x, x, ls, sg, diag, "matern_52", 2.0, 1.5, "radial_gram_diag", None)
        C = rg._RadialGramFunction.apply(x, y, ls, sg, None, "matern_52", 2.0, 1.5, "radial_gram", None)
        return torch.stack(torch.autograd.grad(torch.sum(K * cot) + torch.sum(C * cot_y), (ls, sg)))

    _build.reset_launch_counts()
    whole = grads()
    assert _build.LAUNCHES["radial_gram_d2_highd"] == 2
    kept = rg._D2_BLOCK_ELEMENTS
    rg._D2_BLOCK_ELEMENTS = 1024 * 700  # blocks of 256 columns of K(x, x), 1024 rows of the cross form
    try:
        _build.reset_launch_counts()
        blocked = grads()
        assert _build.LAUNCHES["radial_gram_d2_highd"] == len(range(0, n, 256)) + 3
    finally:
        rg._D2_BLOCK_ELEMENTS = kept
    assert (blocked - whole).abs().max() <= 1e-5 * whole.abs().max()


@pytest.mark.parametrize("d", [32, 33])
def test_highd_cross_form_on_an_unaligned_view(cuda, d):
    """The cross form on views one row into their tensors (Y[1:], whose
    rows start 16-byte aligned only when 4 | D): the kernel reads them in
    place, equal bit for bit to the same gram of contiguous copies, and
    within HIGHD_ATOL of the tiled version."""
    A, B = _line(901, d, seed=d), _line(300, d, seed=d + 1)
    X, Y = A[1:], B[1:]
    assert X.is_contiguous() and (X.data_ptr() % 16 == 0) == (d % 4 == 0)
    _build.reset_launch_counts()
    got = radial_gram(X, Y, 2.0, 1.5, "squared_exponential")
    assert _build.LAUNCHES["radial_gram_highd"] == 1
    assert torch.equal(got, radial_gram(X.clone(), Y.clone(), 2.0, 1.5, "squared_exponential"))
    tiled = plain_radial_gram_tiled(X, Y, 2.0, 1.5, "squared_exponential")
    assert (got - tiled).abs().max() <= HIGHD_ATOL * 1.5**2


def test_highd_tagged_gram_is_bitwise_symmetric(cuda):
    """A tagged batch of two 32-feature sub-batches on the card: K(X, X)
    launches the mirrored form for each tag's block and the cross form
    once for the pair of tags (its transpose is the other block), so it is
    bitwise symmetric, and within HIGHD_ATOL of f64."""
    a, b = _line(700, 32, seed=21), _line(450, 32, seed=22)
    tags = torch.zeros(1150, dtype=torch.int64)
    tags[torch.randperm(1150, generator=torch.Generator().manual_seed(0))[:450]] = 1
    batch = pt.TaggedBatch.create(tags.numpy(), {0: a, 1: b})
    kernel = pt.SquaredExponential(2.0, 1.5)
    _build.reset_launch_counts()
    K = kernel(batch)
    assert _build.LAUNCHES["radial_gram_diag_highd"] == 0 and _build.LAUNCHES["radial_gram_highd"] == 3
    assert torch.equal(K, K.T)
    ref = pt.SquaredExponential(2.0, 1.5)(pt.TaggedBatch.create(tags.numpy(), {0: a.double(), 1: b.double()}))
    assert (K.double() - ref).abs().max() <= HIGHD_ATOL * 1.5**2


def test_highd_cross_form_row_panels_are_symmetric_to_rounding(cuda):
    """What the sharded grams of parallel/ see at D = 32: a rank's rows
    against all of X by the cross form on two distinct batches.  Its
    diagonal block is symmetric only to the contraction's rounding, within
    HIGHD_ATOL (entries (i, j) and (j, i) come from two tiles); below D = 8
    the same panel is bitwise symmetric."""
    for d in (32, 7):
        x = _line(2048, d, seed=d)
        panel = radial_gram(x[512:1536].clone(), x, 2.0, 1.5, "squared_exponential")
        block = panel[:, 512:1536]
        if d < 8:
            assert torch.equal(block, block.T)
        else:
            assert (block - block.T).abs().max() <= HIGHD_ATOL * 1.5**2


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


# sha256 of U's then Wu's f32 bytes from the single-panel kernel as it was
# before the batched kernel shared its device functions (read on an NVIDIA
# H100 80GB HBM3 from the earlier source, built beside the new one): the
# single panel's launch sequence must still give these bits
SINGLE_PANEL_BITS = {
    128: "70030c8fd06e942bda4cfc8c026d037241a10c51194c1576b18203a25def4d61",
    640: "e4b6319b92910baf046392374f46895b15e0cdb8e0ed8061ef0f7dd4cd6526e3",
    1024: "4ee85e8943d76a717d87abc9bacbacf1a44882a258ec020a92d73705a856f355",
}


@pytest.mark.parametrize("b", sorted(SINGLE_PANEL_BITS))
def test_panel_kernel_keeps_its_bits(cuda, b):
    """An integer panel M M^T + b I (exact in f32, the same on every
    machine) through panel_cholinv gives the bits recorded above."""
    import hashlib

    M = np.random.default_rng(b).integers(-2, 3, size=(b, b)).astype(np.float64)
    A = torch.as_tensor(M @ M.T + b * np.eye(b), dtype=torch.float32, device=cuda)
    U, Wu = panel_cholinv(A)
    digest = hashlib.sha256(U.cpu().numpy().tobytes() + Wu.cpu().numpy().tobytes()).hexdigest()
    assert digest == SINGLE_PANEL_BITS[b]


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
    factorization three panels of 768 (two trailing-update launches); f32
    on the card against f64 on the CPU, within about 10x the first reading
    on H100 (5.5e-4)."""
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
                      "radial_gram_highd": 0, "radial_gram_diag_highd": 0, "radial_gram_cols_highd": 0,
                      "radial_gram_diag_batched_highd": 0, "radial_gram_d2_highd": 0,
                      "panel_cholinv": 3, "panel_cholinv_batched": 0,
                      "trailing_update": 2, "trailing_update_backward": 0}
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


# one panel, and stacks of more panels than the grid's blocks take at once
# (40 x 256, 33 x 1024: the queue hands every block tasks of many panels)
@pytest.mark.parametrize("w, b", [(3, 128), (2, 256), (5, 640), (4, 1024), (1, 1024), (40, 256), (33, 1024)])
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
    bad = {0, w // 2, w - 1}  # the first, middle and last slots
    for i in bad:
        A[i, 5, 5] = -1.0
    U, _ = panel_cholinv_batched(A)
    assert [bool(torch.isnan(U[i]).any()) for i in range(w)] == [i in bad for i in range(w)]
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


def test_error_free_transforms_are_exact_on_cuda(cuda):
    """two_sum, two_prod and dw_sum on the card: eager launches do not
    contract a multiply and its add into an FMA, so in f64 a + b == s + e
    and a b == p + e exactly, and the double-word sum of f32 values is
    exact to f64 rounding."""
    from albatross_tpu_torch.ops.compensated import dw_sum, two_prod, two_sum

    g = torch.Generator().manual_seed(5)
    a = (1e3 * torch.randn(1 << 20, generator=g)).to(cuda)
    b = torch.randn(1 << 20, generator=g).to(cuda)
    s, e = two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p, e = two_prod(a, b)
    assert torch.equal(p.double() + e.double(), a.double() * b.double())
    h, l = dw_sum(a)
    exact = a.double().sum().item()
    assert abs(h.item() + l.item() - exact) <= 1e-12 * a.double().abs().sum().item()


@pytest.mark.parametrize("modes", [{"NLML_COMPENSATED": True}, {"CHOLESKY_PRECISION": "double_word"},
                                   {"NLML_COMPENSATED": True, "CHOLESKY_PRECISION": "double_word"}])
def test_accuracy_modes_on_cuda_match_cpu_f64(cuda, modes, monkeypatch):
    """Each accuracy mode's f32 log_likelihood on the card against the CPU
    f64 one at n = 3072 (3 panels of 1024 through the panel kernel), and
    its value+grad at f64 on the card against the CPU's."""
    rng = np.random.default_rng(12)
    n = 3072
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)
    for k, v in modes.items():
        monkeypatch.setattr(config, k, v)
    ref = model.log_likelihood(pt.RegressionDataset.create(x, y, device="cpu", dtype=torch.float64)).item()
    _build.reset_launch_counts()
    got = model.log_likelihood(pt.RegressionDataset.create(x, y, device=cuda, dtype=torch.float32)).item()
    assert abs(got - ref) / abs(ref) < 1e-5
    assert _build.LAUNCHES["panel_cholinv"] == 3 and _build.LAUNCHES["radial_gram_diag"] == 1

    def value_grad(device):
        data = pt.RegressionDataset.create(x, y, device=device, dtype=torch.float64)
        v = model.get_tunable_parameters().values.clone().requires_grad_(True)
        value = -model.set_tunable_params(v).log_likelihood(data)
        return value.item(), torch.autograd.grad(value, v)[0]

    (v_cpu, g_cpu), (v_gpu, g_gpu) = value_grad("cpu"), value_grad(cuda)
    assert v_gpu == pytest.approx(v_cpu, rel=1e-9)
    torch.testing.assert_close(g_gpu.cpu(), g_cpu, rtol=1e-8, atol=1e-8 * g_cpu.abs().max().item())


def test_distributed_gp_on_a_world_of_one_nccl_rank(cuda, tmp_path):
    """The distributed GP on an NCCL world of one rank: fit, predict and
    log_likelihood equal the single-process GP's on the card, f64."""
    import torch.distributed as dist

    from albatross_tpu_torch import parallel as par

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        mesh = par.make_mesh()
        rng = np.random.default_rng(4)
        x = np.sort(rng.uniform(0, 10, 512))
        y = np.sin(x) + 0.1 * rng.standard_normal(512)
        data = pt.RegressionDataset.create(x, y, device=cuda, dtype=torch.float64)
        kernel = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2))
        xs = torch.linspace(0.5, 9.5, 64, dtype=torch.float64, device=cuda)
        multi = par.distributed_gp_from_covariance(kernel, mesh, jitter=1e-8)
        single = pt.gp_from_covariance(kernel, jitter=1e-8)
        p8, p1 = (m.fit(data).predict(xs).marginal() for m in (multi, single))
        torch.testing.assert_close(p8.mean, p1.mean, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(p8.variance, p1.variance, rtol=1e-9, atol=1e-12)
        assert multi.log_likelihood(data).item() == pytest.approx(single.log_likelihood(data).item(), rel=1e-10)
    finally:
        dist.destroy_process_group()


def test_2d_layout_and_distributed_sparse_gp_on_a_world_of_one_nccl_rank(cuda, tmp_path):
    """The 2-D tile layout on a (1, 1) mesh and the distributed FITC on an
    NCCL world of one rank equal the single-process models on the card,
    f64; the 2-D factorization launches no panel kernel in f64."""
    import torch.distributed as dist

    from albatross_tpu_torch import _build
    from albatross_tpu_torch import parallel as par

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        mesh2d = par.make_mesh(axis_names=("data", "model"), shape=(1, 1))
        rng = np.random.default_rng(5)
        x = np.sort(rng.uniform(0, 10, 2048))
        y = np.sin(x) + 0.1 * rng.standard_normal(2048)
        data = pt.RegressionDataset.create(x, y, device=cuda, dtype=torch.float64)
        kernel = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2))
        xs = torch.linspace(0.5, 9.5, 64, dtype=torch.float64, device=cuda)
        multi = par.distributed_gp_from_covariance(kernel, mesh2d, col_axis="model", panel=512, jitter=1e-8)
        single = pt.gp_from_covariance(kernel, jitter=1e-8)
        _build.reset_launch_counts()
        p2, p1 = (m.fit(data).predict(xs).marginal() for m in (multi, single))
        torch.testing.assert_close(p2.mean, p1.mean, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(p2.variance, p1.variance, rtol=1e-9, atol=1e-12)
        assert multi.log_likelihood(data).item() == pytest.approx(single.log_likelihood(data).item(), rel=1e-10)
        assert _build.LAUNCHES["panel_cholinv"] == 0
        sparse_kw = dict(inducing_point_strategy=pt.UniformlySpacedInducingPoints(64))
        sparse = par.distributed_sparse_gp_from_covariance(kernel, par.make_mesh(), **sparse_kw)
        q2, q1 = (m.fit(data).predict(xs).marginal() for m in (sparse, pt.sparse_gp_from_covariance(kernel,
                                                                                                  **sparse_kw)))
        torch.testing.assert_close(q2.mean, q1.mean, rtol=1e-9, atol=1e-12)
        torch.testing.assert_close(q2.variance, q1.variance, rtol=1e-9, atol=1e-12)
    finally:
        dist.destroy_process_group()


def test_f32_loo_likelihood_on_cuda_scores_every_fold_in_one_batch(cuda, monkeypatch):
    """An f32 LOO likelihood and its gradient on the card take the batched
    scores (one vmap over the folds), never the fold-by-fold loop: torch
    2.11 has no batching rule for ``Tensor.view(dtype)`` in
    ``accurate_log``, so it needs its own vmap rule."""
    from albatross_tpu_torch.evaluation import LeaveOneOutLikelihood, cross_validation

    def fold_by_fold(*args):
        raise AssertionError("the scores fell back to one fold at a time")

    monkeypatch.setattr(cross_validation, "cross_validated_scores", fold_by_fold)
    x = np.sort(np.random.default_rng(6).uniform(0.0, 100.0, 3072))
    data = pt.RegressionDataset.create(x, np.sin(0.3 * x), device=cuda, dtype=torch.float32)
    model = pt.gp_from_covariance(pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True)))
    v = model.get_tunable_parameters().values.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(LeaveOneOutLikelihood()(data, model.set_tunable_params(v)), v)
    assert torch.isfinite(grad).all()


RACE_WORLD, RACE_REPEATS = 4, 50


def _sparse_value_grad_rank(rank: int, root: str) -> None:
    """A rank of a gloo world sharing the card: the distributed FITC's
    value+grad RACE_REPEATS times; writes how many it finished."""
    import datetime
    import pickle
    import traceback

    import torch.distributed as dist

    from albatross_tpu_torch import parallel as par

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", world_size=RACE_WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    done, error = 0, None
    try:
        x = np.sort(np.random.default_rng(5).uniform(0.0, 100.0, 8192)).astype(np.float32)
        data = pt.RegressionDataset.create(x, np.sin(0.3 * x), dtype=torch.float32)
        kernel = pt.SquaredExponential(0.2, 1.0) + pt.measurement_only(pt.IndependentNoise(0.3))
        model = par.distributed_sparse_gp_from_covariance(
            kernel, par.make_mesh(), inducing_point_strategy=pt.UniformlySpacedInducingPoints(256))
        for _ in range(RACE_REPEATS):
            v = model.get_tunable_parameters().values.clone().requires_grad_(True)
            torch.autograd.grad(-model.set_tunable_params(v).log_likelihood(data), v)
            done += 1
    except Exception:  # the test fails with it
        error = traceback.format_exc()
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump((done, error), f)
    dist.destroy_process_group()


def test_distributed_sparse_value_grad_on_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """The distributed FITC's value+grad, repeated on a gloo world of 4
    processes sharing the card: every rank finishes every repeat.  Its
    backward runs collectives on autograd's device thread; a parameter
    left on the CPU (the measurement nugget once was) put one on the CPU
    thread too, in an order that differed between ranks, and gloo aborted
    the world on the mismatched sizes now and then."""
    import multiprocessing
    import os
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_sparse_value_grad_rank, args=(r, str(tmp_path))) for r in range(RACE_WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    results = []
    for r, p in enumerate(procs):
        path = tmp_path / f"rank{r}.pkl"
        assert os.path.exists(path), f"rank {r} wrote no result (exit code {p.exitcode})"
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    assert all(error is None for _, error in results), [error for _, error in results if error]
    assert [done for done, _ in results] == [RACE_REPEATS] * RACE_WORLD
