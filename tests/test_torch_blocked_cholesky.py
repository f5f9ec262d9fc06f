"""Port parity: albatross_tpu_torch.ops.blocked_cholesky / linalg vs the JAX package.

The same f64 SPD matrices and right-hand sides go through the JAX package's
``blocked_cholesky_cols`` / ``CholeskyFactor.nlml_terms`` and the port's.
Both run the same blocked algorithm in f64 (the JAX side with its default
panel path, the port's CPU path is the same), so results agree to 1e-10
relative: the bound is rounding of an O(n^3) f64 computation on matrices of
condition ~1e3.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from albatross_tpu.ops.linalg import CholeskyFactor as JaxCholeskyFactor
from albatross_tpu_torch.ops.linalg import CholeskyFactor

# the packages' ops/__init__ re-export a function named blocked_cholesky
jbc = importlib.import_module("albatross_tpu.ops.blocked_cholesky")
tbc = importlib.import_module("albatross_tpu_torch.ops.blocked_cholesky")

torch.set_num_threads(2)
RTOL = 1e-10


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    K = A @ A.T / n + np.eye(n)
    return K, rng.standard_normal(n)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.max(np.abs(a - b)) <= RTOL * np.max(np.abs(b))


@pytest.mark.parametrize("n,b", [(768, 256), (800, 256)])
@pytest.mark.parametrize("assemble", [True, False])
def test_blocked_cholesky_cols_matches_jax(n, b, assemble):
    K, y = _problem(n)
    if assemble:
        _close(tbc.blocked_cholesky_cols(torch.as_tensor(K), block_size=b),
               jbc.blocked_cholesky_cols(jnp.asarray(K), block_size=b))
    ref = jbc.blocked_cholesky_cols(jnp.asarray(K), block_size=b, rhs=jnp.asarray(y), assemble=assemble)
    got = tbc.blocked_cholesky_cols(torch.as_tensor(K), block_size=b, rhs=torch.as_tensor(y), assemble=assemble)
    _close(got[0], ref[0])
    _close(got[1], ref[1])


def test_assemble_false_requires_rhs():
    with pytest.raises(ValueError, match="requires rhs"):
        tbc.blocked_cholesky_cols(torch.eye(512), block_size=256, assemble=False)


def test_block_size_policies():
    for n in (2113, 2304, 4096, 28672, 30000, 100000):
        assert tbc.auto_block_size(n) == jbc.auto_block_size(n)
    assert tbc.cuda_block_size(28672) == 1024  # 28 panels
    assert tbc.cuda_block_size(2304) == 768
    assert tbc.cuda_block_size(2560) == 640
    assert tbc.cuda_block_size(2113) == 1024  # no divisor: identity padding


@pytest.mark.parametrize("m,sub", [(512, 128), (384, 256), (256, 256)])
def test_blocked_tri_inverse_matches_jax(m, sub):
    K, _ = _problem(m, seed=1)
    L = np.linalg.cholesky(K)
    _close(tbc.blocked_tri_inverse(torch.as_tensor(L), sub),
           jbc.blocked_tri_inverse(jnp.asarray(L), sub))


@pytest.mark.parametrize("n", [300, 2304])
def test_nlml_terms_matches_jax(n):
    """n = 2304 > 2048 takes the blocked no-assemble path with identity
    padding (auto_block_size(2304) = 1024)."""
    K, y = _problem(n, seed=2)
    ld_ref, w_ref = JaxCholeskyFactor.nlml_terms(jnp.asarray(K), jnp.asarray(y), jitter=1e-3)
    ld, w = CholeskyFactor.nlml_terms(torch.as_tensor(K), torch.as_tensor(y), jitter=1e-3)
    assert float(ld) == pytest.approx(float(ld_ref), rel=RTOL)
    _close(w, w_ref)


def test_factorize_solves_match_jax():
    K, y = _problem(300, seed=3)
    ref = JaxCholeskyFactor.factorize(jnp.asarray(K))
    got = CholeskyFactor.factorize(torch.as_tensor(K))
    _close(got.L, ref.L)
    _close(got.solve(torch.as_tensor(y)), ref.solve(jnp.asarray(y)))
    _close(got.sqrt_solve(torch.as_tensor(y)), ref.sqrt_solve(jnp.asarray(y)))
    assert float(got.log_determinant()) == pytest.approx(float(ref.log_determinant()), rel=RTOL)
    fw, white = CholeskyFactor.factorize_whiten(torch.as_tensor(K), torch.as_tensor(y))
    _close(white, ref.sqrt_solve(jnp.asarray(y)))
    with pytest.raises(ValueError, match="1-D rhs"):
        CholeskyFactor.factorize_whiten(torch.as_tensor(K), torch.zeros((300, 2), dtype=torch.float64))


def test_not_positive_definite_surfaces_as_nan():
    """As in the JAX package, a failed factorization is NaN, not an error."""
    K = -torch.eye(64, dtype=torch.float64)
    ld, _ = CholeskyFactor.nlml_terms(K, torch.ones(64, dtype=torch.float64))
    assert torch.isnan(ld)


@pytest.mark.parametrize("call", ["positional_use_inverse", "solve_route", "panel_sub_none", "rhs_fourth"])
def test_blocked_cholesky_takes_the_reference_signature(call):
    """(K, block_size, use_inverse, rhs, panel_sub) in the JAX package's
    order: a third positional argument is use_inverse, a fourth the
    right-hand side; every route gives the reference's factor."""
    K, rhs = _problem(384, seed=5)
    jK, jr = jnp.asarray(K), jnp.asarray(rhs)
    tK, tr = torch.tensor(K), torch.tensor(rhs)
    args = {"positional_use_inverse": (128, True), "solve_route": (128, False),
            "panel_sub_none": (128, True, None, None), "rhs_fourth": (128, True, "rhs")}[call]
    targs = tuple(tr if a == "rhs" else a for a in args)
    jargs = tuple(jr if a == "rhs" else a for a in args)
    got, want = tbc.blocked_cholesky(tK, *targs), jbc.blocked_cholesky(jK, *jargs)
    if call == "rhs_fourth":
        (got, gz), (want, wz) = got, want
        np.testing.assert_allclose(gz.numpy(), np.asarray(wz), rtol=RTOL, atol=RTOL * np.abs(np.asarray(wz)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=RTOL * np.abs(np.asarray(want)).max())
