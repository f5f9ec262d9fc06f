"""Port parity of the gram kernel's high-D branch (f32, D >= 8).

``plain_radial_gram_tiled`` is the branch's plain version: the JAX
package's ``_gram_kernel`` at D >= 8 (per-tile-pair centred contraction,
exact recompute of the tiles whose smallest d^2 lies inside the profile's
support) in torch ops at the kernel's tile of 128.  The same numpy inputs
go through it and through ``pallas_radial_gram(tile=128, interpret=True)``;
the JAX package's own high-D tests have counterparts here; refined tiles
hold the exact closed form's bits; the backward that differentiates the
profile on the kernel's squared distances is held against the JAX
package's custom VJP; and the 32-feature GP of the slice runs in f64
against the JAX package.  The CUDA kernel itself is held to the tiled
version in tests/test_torch_cuda.py and chip_smoke.py.

Data: the slice's law, X = 1000 + t u + 0.05 xi with t sorted on [0, 100],
u a unit vector and xi ~ N(0, I): the offset makes an uncentred
|x|^2 - 2 x.y contraction fail, and the line makes some tiles near and the
rest far, so both paths run.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.ops.pallas_gram import _fused_bwd, _fused_diag_bwd, pallas_radial_gram
from albatross_tpu_torch.convert import params_from_numpy, tunable_to_numpy
from albatross_tpu_torch.ops.radial_gram import (
    PROFILES,
    plain_radial_gram,
    plain_radial_gram_tiled,
    tiled_squared_distances,
)

rg = importlib.import_module("albatross_tpu_torch.ops.radial_gram")

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))

SIGMA = 1.5  # sigma^2 = 2.25 is exact in f32
LS = 2.0     # the slice's length scale: SE refines where d^2 <= 28, |dt| <~ 5.3


def line_data(n, d, seed, offset=1000.0):
    """n points of the slice's law in R^d, sorted along the line, f32."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 100.0, n))
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    return (offset + t[:, None] * u[None, :] + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


def split(A, n, seed):
    """Rows of A in two sorted random halves: the cross gram's near tiles
    lie along its diagonal band."""
    perm = np.random.default_rng(seed).permutation(A.shape[0])
    return A[np.sort(perm[:n])], A[np.sort(perm[n:])]


def tile_mask(refined, n, m, tile=128):
    return refined.repeat_interleave(tile, 0).repeat_interleave(tile, 1)[:n, :m]


# f32: the two versions round the same contraction differently (XLA's
# and torch's f32 products), at most 7.2e-7 measured at sigma^2 = 2.25
# (3.2e-7 sigma^2); 2e-6 sigma^2 leaves 6x.  A tile whose minimum sat at
# the cut could refine in one and not the other; the far-field error there
# is smaller still.
TILED_ATOL = 2e-6 * SIGMA**2


@pytest.mark.parametrize("d", [8, 9, 16, 32])
@pytest.mark.parametrize("profile", PROFILES)
def test_tiled_gram_matches_pallas(profile, d):
    """Cross (600, 300) and training covariance (600, 600) + diag, both
    ragged against the 128 tile, f32, every profile."""
    X, Y = split(line_data(900, d, seed=d), 600, seed=d)
    diag = np.random.default_rng(d).uniform(0.1, 0.5, 600).astype(np.float32)
    ref = np.asarray(pallas_radial_gram(jnp.asarray(X), jnp.asarray(Y), LS, SIGMA, profile, tile=128,
                                        interpret=True))
    got = plain_radial_gram_tiled(torch.as_tensor(X), torch.as_tensor(Y), LS, SIGMA, profile)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TILED_ATOL)
    _, refined = tiled_squared_distances(torch.as_tensor(X), torch.as_tensor(Y), LS, profile)
    assert refined.any() and not refined.all()  # both paths ran

    ref_d = np.asarray(pallas_radial_gram(jnp.asarray(X), jnp.asarray(X), LS, SIGMA, profile, tile=128,
                                          interpret=True, diag_add=jnp.asarray(diag)))
    Xt = torch.as_tensor(X)
    got_d = plain_radial_gram_tiled(Xt, Xt, LS, SIGMA, profile, torch.as_tensor(diag))
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=TILED_ATOL)
    assert torch.equal(got_d, got_d.T)
    assert torch.equal(got_d.diagonal(), torch.tensor(SIGMA**2) + torch.as_tensor(diag))


def test_tiled_gram_adversarial_cancellation(rng):
    """tests/test_pallas_gram.py's adversarial case: features of magnitude
    1e4 with unit-scale structure.  At its length scale (2) every tile
    refines; at 0.5 the off-diagonal tiles take the centred contraction,
    whose d^2 stays within 1e-3 of f64 (eps times the tiles' spread
    squared, about 2e-5 read), while the global uncentred |x|^2 - 2 x.y
    is off by more than 1 (eps |x|^2 ~ 10)."""
    n, d = 300, 16
    base = 1e4 + rng.standard_normal((1, d))
    X = torch.as_tensor((base + rng.standard_normal((n, d))).astype(np.float32))
    X64 = X.double()
    D2 = torch.sum((X64[:, None, :] - X64[None, :, :]) ** 2, dim=-1)
    K = plain_radial_gram_tiled(X, X, 2.0, SIGMA, "squared_exponential")
    torch.testing.assert_close(K.double(), SIGMA**2 * torch.exp(-D2 / 4.0), rtol=0, atol=5e-6)
    d2, refined = tiled_squared_distances(X, X, 0.5, "squared_exponential")
    off = ~tile_mask(refined, n, n)
    assert off.any() and refined.diagonal().all()
    assert (d2.double() - D2)[off].abs().max() <= 1e-3
    x2 = torch.sum(X64 * X64, dim=-1)
    broken = x2[:, None] + x2[None, :] - 2.0 * (X @ X.T).double()
    assert (broken - D2).abs().max() > 1.0


def test_tiled_gram_symmetric_and_exact_diagonal(rng):
    """tests/test_pallas_gram.py's symmetry case at D = 32: K(X, X) is
    bitwise symmetric with k(x, x) = sigma^2 exactly and within 5e-6 of f64;
    only the diagonal tiles refine there."""
    n, d = 280, 32
    X = torch.as_tensor(rng.uniform(0, 100, (n, d)).astype(np.float32))
    K = plain_radial_gram_tiled(X, X, 10.0, SIGMA, "squared_exponential")
    assert torch.equal(K, K.T)
    assert torch.equal(K.diagonal(), torch.full((n,), SIGMA**2))
    X64 = X.double()
    D2 = torch.sum((X64[:, None, :] - X64[None, :, :]) ** 2, dim=-1)
    torch.testing.assert_close(K.double(), SIGMA**2 * torch.exp(-D2 / 100.0), rtol=0, atol=5e-6)
    _, refined = tiled_squared_distances(X, X, 10.0, "squared_exponential")
    assert torch.equal(refined, torch.eye(3, dtype=torch.bool))


@pytest.mark.parametrize("profile", PROFILES)
def test_tiled_refined_tiles_equal_the_exact_closed_form(profile):
    """A refined tile is the exact closed form's, bit for bit (cross and
    symmetric, f32); the rest are within TILED_ATOL of it."""
    X, Y = (torch.as_tensor(a) for a in split(line_data(900, 32, seed=1), 600, seed=1))
    for P, Q in ((X, Y), (X, X)):
        got = plain_radial_gram_tiled(P, Q, LS, SIGMA, profile)
        exact = plain_radial_gram(P, Q, LS, SIGMA, profile)
        _, refined = tiled_squared_distances(P, Q, LS, profile)
        inside = tile_mask(refined, P.shape[0], Q.shape[0])
        assert inside.any() and not inside.all()
        assert torch.equal(got[inside], exact[inside])
        assert (got - exact)[~inside].abs().max() <= TILED_ATOL


def _cpu_launch(launches):
    """The kernel's launch on CPU tensors, by the tiled plain version: what
    the CUDA launch computes, for driving the autograd Function here."""

    def launch(X, Y, length_scale, sigma, diag, profile, counter, cols=None, squared_distance=False):
        launches.append((counter, squared_distance))
        if cols is not None:
            x, j0, b = cols
            d2 = tiled_squared_distances(x, x, length_scale, profile)[0][j0:, j0:j0 + b].contiguous()
        else:
            d2 = tiled_squared_distances(X, Y, length_scale, profile)[0]
        if squared_distance:
            return d2
        out = rg.apply_profile(profile, d2, length_scale, sigma)
        if diag is not None:
            out.diagonal().add_(diag)
        return out

    return launch


# f32 gradients of the profile on the kernel's d^2 against the JAX
# package's closed-form VJP in f64 on the same (f32) inputs, relative to
# the largest entry: 2.4e-7 read (f32 rounding of sums over 600^2 terms);
# 2e-6 leaves 8x.
GRAD_RTOL = 2e-6


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


@pytest.mark.parametrize("profile", PROFILES)
def test_squared_distance_backward_matches_jax_vjp(monkeypatch, profile):
    """The high-D Function's backward with X and Y not requiring grad: one
    squared-distance launch, then the profile (+ diagonal) differentiated
    -- against ``jax.vjp`` of ``_fused_diag_bwd`` (training covariance) and
    ``_fused_bwd`` (cross), and summed over column blocks as the lazy loop
    takes them.  With X requiring grad it keeps the closed form."""
    launches = []
    monkeypatch.setattr(rg, "_launch", _cpu_launch(launches))
    X, Y = (torch.as_tensor(a) for a in split(line_data(900, 32, seed=2), 600, seed=2))
    rng = np.random.default_rng(2)
    diag = torch.as_tensor(rng.uniform(0.1, 0.5, 600).astype(np.float32))
    cot = rng.standard_normal((600, 600)).astype(np.float32)
    cot_y = rng.standard_normal((600, 300)).astype(np.float32)
    X64, Y64 = (jnp.asarray(t.numpy(), jnp.float64) for t in (X, Y))

    def leaves():
        return (torch.tensor(LS, requires_grad=True), torch.tensor(SIGMA, requires_grad=True),
                diag.clone().requires_grad_(True))

    ls, sg, dg = leaves()
    K = rg._RadialGramFunction.apply(X, X, ls, sg, dg, profile, LS, SIGMA, "radial_gram_diag", None)
    got = torch.autograd.grad(K, (ls, sg, dg), torch.as_tensor(cot))
    assert launches == [("radial_gram_diag", False), ("radial_gram_d2", True)]
    _, gl, gs, gd = _fused_diag_bwd(profile, (X64, jnp.float64(LS), jnp.float64(SIGMA),
                                              jnp.asarray(diag.numpy(), jnp.float64)), jnp.asarray(cot, jnp.float64))
    for g, r in zip(got, (gl, gs, gd)):
        assert _rel(g.numpy(), r) <= GRAD_RTOL

    ls, sg, _ = leaves()
    C = rg._RadialGramFunction.apply(X, Y, ls, sg, None, profile, LS, SIGMA, "radial_gram", None)
    got = torch.autograd.grad(C, (ls, sg), torch.as_tensor(cot_y))
    _, _, gl, gs = _fused_bwd(profile, 128, (X64, Y64, jnp.float64(LS), jnp.float64(SIGMA)),
                              jnp.asarray(cot_y, jnp.float64))
    for g, r in zip(got, (gl, gs)):
        assert _rel(g.numpy(), r) <= GRAD_RTOL

    # column blocks [j0, j0 + b): the cotangent's lower part, as the lazy loop
    # reads it; their gradients sum to the whole lower triangle's
    ls, sg, dg = leaves()
    low = np.tril(cot)
    total = 0.0
    for j0 in range(0, 600, 256):
        b = min(256, 600 - j0)
        col = rg._RadialGramFunction.apply(X[j0:], X[j0:j0 + b], ls, sg, dg[j0:j0 + b], profile, LS, SIGMA,
                                           "radial_gram_cols", (X, j0, b))
        total = total + torch.sum(col * torch.as_tensor(low[j0:, j0:j0 + b]))
    got = torch.autograd.grad(total, (ls, sg, dg))
    _, gl, gs, gd = _fused_diag_bwd(profile, (X64, jnp.float64(LS), jnp.float64(SIGMA),
                                              jnp.asarray(diag.numpy(), jnp.float64)), jnp.asarray(low, jnp.float64))
    for g, r in zip(got, (gl, gs, gd)):
        assert _rel(g.numpy(), r) <= GRAD_RTOL

    launches.clear()
    Xg = X.clone().requires_grad_(True)
    C = rg._RadialGramFunction.apply(Xg, Y, torch.tensor(LS), torch.tensor(SIGMA), None, profile, LS, SIGMA,
                                     "radial_gram", None)
    (gx,) = torch.autograd.grad(C, (Xg,), torch.as_tensor(cot_y))
    assert launches == [("radial_gram", False)] and torch.isfinite(gx).all()


@pytest.mark.parametrize("profile", ["squared_exponential", "matern_32"])
def test_squared_distance_backward_in_blocks(monkeypatch, profile):
    """The backward's d^2 taken in blocks of the global grid (K(x, x) by
    column blocks weighted with their mirrored rows, the cross form by row
    blocks) gives the gradient of one whole block: with blocks of 256
    columns (three at n = 600) and 512 rows (two), the same launches
    counted per block, within GRAD_RTOL of one launch's gradient and of
    ``jax.vjp``."""
    launches = []
    monkeypatch.setattr(rg, "_launch", _cpu_launch(launches))
    X, Y = (torch.as_tensor(a) for a in split(line_data(900, 32, seed=3), 600, seed=3))
    rng = np.random.default_rng(3)
    diag = torch.as_tensor(rng.uniform(0.1, 0.5, 600).astype(np.float32))
    cot = torch.as_tensor(rng.standard_normal((600, 600)).astype(np.float32))
    cot_y = torch.as_tensor(rng.standard_normal((600, 300)).astype(np.float32))

    def grads(block_elements):
        monkeypatch.setattr(rg, "_D2_BLOCK_ELEMENTS", block_elements)
        launches.clear()
        ls, sg, dg = (torch.tensor(LS, requires_grad=True), torch.tensor(SIGMA, requires_grad=True),
                      diag.clone().requires_grad_(True))
        K = rg._RadialGramFunction.apply(X, X, ls, sg, dg, profile, LS, SIGMA, "radial_gram_diag", None)
        C = rg._RadialGramFunction.apply(X, Y, ls, sg, None, profile, LS, SIGMA, "radial_gram", None)
        out = torch.autograd.grad(torch.sum(K * cot) + torch.sum(C * cot_y), (ls, sg, dg))
        return out, [c for c, d2 in launches if d2]

    whole, whole_launches = grads(1 << 25)
    blocked, blocked_launches = grads(256 * 600)
    assert whole_launches == ["radial_gram_d2"] * 2
    assert blocked_launches == ["radial_gram_d2"] * (3 + 2)  # columns 0, 256, 512; rows 0, 512
    for g, r in zip(blocked, whole):
        assert _rel(g.numpy(), r.numpy()) <= GRAD_RTOL
    X64, Y64 = (jnp.asarray(t.numpy(), jnp.float64) for t in (X, Y))
    _, gl, gs, gd = _fused_diag_bwd(profile, (X64, jnp.float64(LS), jnp.float64(SIGMA),
                                              jnp.asarray(diag.numpy(), jnp.float64)),
                                    jnp.asarray(cot.numpy(), jnp.float64))
    _, _, gl_y, gs_y = _fused_bwd(profile, 128, (X64, Y64, jnp.float64(LS), jnp.float64(SIGMA)),
                                  jnp.asarray(cot_y.numpy(), jnp.float64))
    for g, r in zip(blocked, (gl + gl_y, gs + gs_y, gd)):
        assert _rel(g.numpy(), r) <= GRAD_RTOL


def _slice_models():
    jk = ab.SquaredExponential(2.0, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True))
    tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    jm = ab.gp_from_covariance(jk, jitter=1e-4)
    tm = params_from_numpy(pt.gp_from_covariance(tk, jitter=1e-4),
                           {k: np.asarray(p.value) for k, p in jm.get_params().items()})
    return jm, tm


# Relative to the largest entry.  The JAX package forms distances at
# D = 32 as |x|^2 + |y|^2 - 2 x.y, off by eps |x|^2 ~ 7e-9 at this offset
# of 1000 (the port's exact differences are not): on the same data the two
# read 5.9e-9 (NLML), 2.0e-10 (gradient), 1.2e-8 (mean) and 2.3e-8
# (variance), gated at 10x.  The GP is translation-invariant, so on the
# data moved to the origin, where JAX's distances lose only eps times the
# spread squared, the two agree to 1e-9, as tests/test_torch_grad.py: f64
# rounding of O(n^3) work amplified by K's condition number.
SLICE_F64_RTOL = {"nlml": 6e-8, "gradient": 2e-9, "mean": 1.2e-7, "variance": 2.3e-7}
CENTRED_F64_RTOL = 1e-9


def _slice_outputs(model, data, x0, xs, grad, tensor):
    """(-NLML, its gradient with respect to the tunable vector, predicted
    mean, predicted variance) of one package's model, as numpy."""
    value, gradient = grad(lambda x: -model.set_tunable_params(x).log_likelihood(data), tensor(x0))
    pred = model.fit(data).predict(tensor(xs)).marginal()
    return [np.asarray(t, np.float64) for t in (value, gradient, pred.mean, pred.variance)]


def _torch_value_and_grad(fn, x):
    x = x.clone().requires_grad_(True)
    value = fn(x)
    (gradient,) = torch.autograd.grad(value, x)
    return value.detach(), gradient


def test_slice_f64_matches_jax():
    """The slice's 32-feature GP in f64 at n = 2113 (the blocked loop,
    identity-padded): NLML, fit + predict of 300 points of the same law
    (mean and variance) and the gradient of -NLML with respect to the
    tunable vector, against the JAX package in x64 on the same data and
    on the data moved to the origin."""
    n, m = 2113, 300
    A = line_data(n + m, 32, seed=5).astype(np.float64)
    X, Xs = split(A, n, seed=5)
    t = (X - 1000.0) @ np.ones(32) / np.sqrt(32.0)
    y = np.sin(0.3 * t) + 0.1 * np.random.default_rng(5).standard_normal(n)
    jm, tm = _slice_models()
    x0 = np.array(jm.get_tunable_parameters().values)  # a writable copy
    names, values, _, _ = tunable_to_numpy(tm.get_tunable_parameters())
    assert names == jm.get_tunable_parameters().names
    np.testing.assert_allclose(values, x0, rtol=1e-15)
    got = _slice_outputs(tm, pt.RegressionDataset.create(torch.as_tensor(X), torch.as_tensor(y)), x0, Xs,
                         _torch_value_and_grad, torch.as_tensor)
    keys = ("nlml", "gradient", "mean", "variance")
    errors = {}
    for offset in (0.0, 1000.0):
        jd = ab.RegressionDataset.create(jnp.asarray(X - offset), jnp.asarray(y))
        ref = _slice_outputs(jm, jd, x0, Xs - offset, lambda f, x: jax.value_and_grad(f)(x), jnp.asarray)
        errors[offset] = {k: _rel(a, b) for k, a, b in zip(keys, got, ref)}
    print(f"same data {errors[0.0]}, JAX on centred data {errors[1000.0]}")
    assert all(errors[0.0][k] <= tol for k, tol in SLICE_F64_RTOL.items()), errors
    assert all(e <= CENTRED_F64_RTOL for e in errors[1000.0].values()), errors
