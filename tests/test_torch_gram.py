"""Port parity: albatross_tpu_torch.ops.radial_gram vs the Pallas gram kernels.

The same numpy inputs go through ``pallas_radial_gram(interpret=True)`` (the
JAX package's ``_gram_kernel`` / ``_gram_diag_kernel``, run as its own tests
run them on the CPU) and through the port's ``radial_gram``, which on CPU
tensors evaluates its plain closed form.

Tolerances: f64 inputs agree to 1e-12 absolute (the same expressions; at
D = 16 the Pallas kernel contracts centred coordinates outside the
profile's support, which differs from exact distances at eps * spread^2).
f32 inputs agree to 1e-5 * sigma^2 (a few ulp of exp and division, and the
same centred contraction at f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albatross_tpu.ops.pallas_gram import pallas_radial_gram
from albatross_tpu_torch.ops.radial_gram import PROFILES, fused_training_covariance, radial_gram
import albatross_tpu_torch as pt

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))

SIGMA = 1.5  # sigma^2 = 2.25 is exact in f32, so the diagonal checks are exact


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gram_matches_pallas(profile, d, dtype):
    rng = np.random.default_rng(d)
    X = rng.uniform(0, 6, (300, d)).astype(dtype)
    Y = rng.uniform(0, 6, (141, d)).astype(dtype)
    diag = rng.uniform(0.1, 0.5, 300).astype(dtype)
    atol = 1e-12 if dtype == np.float64 else 1e-5 * SIGMA**2

    ref = np.asarray(pallas_radial_gram(jnp.asarray(X), jnp.asarray(Y), 3.0, SIGMA,
                                        profile, interpret=True))
    got = radial_gram(torch.as_tensor(X), torch.as_tensor(Y), 3.0, SIGMA, profile)
    assert got.dtype == torch.from_numpy(X).dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=atol)

    ref_d = np.asarray(pallas_radial_gram(jnp.asarray(X), jnp.asarray(X), 3.0, SIGMA,
                                          profile, interpret=True, diag_add=jnp.asarray(diag)))
    Xt, dt = torch.as_tensor(X), torch.as_tensor(diag)
    got_d = radial_gram(Xt, Xt, 3.0, SIGMA, profile, diag_add=dt)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=atol)
    # elementwise distances: bitwise symmetric, k(x, x) = sigma^2 exactly
    assert torch.equal(got_d, got_d.T)
    assert torch.equal(got_d.diagonal(), torch.tensor(SIGMA**2, dtype=dt.dtype) + dt)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_training_covariance_symmetric_at_high_d(dtype):
    """At D = 16 the training covariance is still bitwise symmetric (the
    factorization assumes it) and the diagonal keeps its noise + jitter."""
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.uniform(0, 6, (200, 16))).to(dtype)
    kernel = pt.Matern32(3.0, SIGMA) + pt.measurement_only(pt.IndependentNoise(0.2, assume_unique=True))
    K = fused_training_covariance(kernel, X, jitter=1e-3)
    assert torch.equal(K, K.T)
    ref = radial_gram(X.double(), X.double(), 3.0, SIGMA, "matern_32") + (0.04 + 1e-3) * torch.eye(200, dtype=torch.float64)
    np.testing.assert_allclose(K.double().numpy(), ref.numpy(), rtol=0,
                               atol=1e-12 if dtype == torch.float64 else 2e-5)


def test_kernel_classes_match_jax_closed_forms():
    """Each radial kernel class, with the JAX package's parameter names,
    against the JAX kernel on the same features (f64, 1e-12)."""
    import albatross_tpu as ab

    rng = np.random.default_rng(3)
    X = rng.uniform(0, 10, (50, 2))
    Y = rng.uniform(0, 10, (30, 2))
    for name in ("SquaredExponential", "Exponential", "Matern32", "Matern52"):
        jk = getattr(ab, name)(2.5, 1.3)
        tk = getattr(pt, name)(2.5, 1.3)
        assert sorted(jk.get_params()) == sorted(tk.get_params())
        np.testing.assert_allclose(tk(torch.as_tensor(X), torch.as_tensor(Y)).numpy(),
                                   np.asarray(jk(jnp.asarray(X), jnp.asarray(Y))), rtol=0, atol=1e-12)
        np.testing.assert_allclose(tk.diag(torch.as_tensor(X)).numpy(),
                                   np.asarray(jk.diag(jnp.asarray(X))), rtol=0, atol=1e-12)
    # the length_scale > 0 guard of the closed forms
    zero = pt.SquaredExponential(0.0, 1.0)(torch.as_tensor(X))
    assert torch.equal(zero, torch.zeros_like(zero))


@pytest.mark.parametrize("d", [1, 3, 8, 16])
def test_euclidean_distance_matches_jax(d):
    """Broadcast form up to D = 8, the matmul form above it, as in the JAX
    package (f64, 1e-12 on distances of order 10)."""
    from albatross_tpu.kernels.distances import EuclideanDistance as JaxEuclidean

    rng = np.random.default_rng(11 + d)
    X = rng.uniform(0, 6, (40, d))
    Y = rng.uniform(0, 6, (25, d))
    ref, tm = JaxEuclidean(), pt.EuclideanDistance()
    for name in ("pairwise", "pairwise_squared"):
        got = getattr(tm, name)(torch.as_tensor(X), torch.as_tensor(Y)).numpy()
        want = np.asarray(getattr(ref, name)(jnp.asarray(X), jnp.asarray(Y)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert torch.equal(tm.diag(torch.as_tensor(X)), torch.zeros(40, dtype=torch.float64))


def test_gradients_flow_through_plain_gram():
    """Parameters that require grad get finite gradients on the CPU path
    (the CUDA path's backward is this same closed form)."""
    X = torch.linspace(0, 10, 40, dtype=torch.float64)
    ls = torch.tensor(1.7, dtype=torch.float64, requires_grad=True)
    K = radial_gram(X, X, ls, 2.0, "squared_exponential")
    (g,) = torch.autograd.grad((K * K.cos()).sum(), ls)
    import jax

    from albatross_tpu.kernels.radial import squared_exponential_covariance

    Xj = jnp.asarray(X.numpy())

    def loss(l):
        Kj = squared_exponential_covariance(jnp.abs(Xj[:, None] - Xj[None, :]), l, 2.0)
        return jnp.sum(Kj * jnp.cos(Kj))

    assert float(g) == pytest.approx(float(jax.grad(loss)(1.7)), rel=1e-10)
