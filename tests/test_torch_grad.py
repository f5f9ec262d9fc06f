"""Port parity of gradients: the NLML, the panel Function, the inverse.

The same numpy inputs go through the JAX package (``jax.grad`` /
``jax.vjp``, f64 on the CPU) and the port (autograd, f64 on the CPU, where
each kernel's Function runs its plain forward and its own backward).  Both
differentiate the same blocked algorithm (builtin Cholesky at n <= 2048;
the column-panel loop above it, identity-padded at n = 2113), so
gradients agree to 1e-9 relative to their largest entry: f64 rounding of
O(n^3) work amplified by the condition number of K (~1e3 here), as in
tests/test_torch_gp.py.  The panel Function's backward is a closed form
and the JAX package's is autodiff of Cholesky + blocked inverse, the same
derivative computed two ways: 1e-9 as well.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu_torch import _build
from albatross_tpu_torch.convert import params_from_numpy, tunable_to_numpy
from albatross_tpu_torch.ops.panel_cholinv import _PanelCholInv, panel_cholinv, panel_cholinv_function

jbc = importlib.import_module("albatross_tpu.ops.blocked_cholesky")
tbc = importlib.import_module("albatross_tpu_torch.ops.blocked_cholesky")

torch.set_num_threads(2)
RTOL = 1e-9


def _models(kind, jitter=1e-4):
    if kind == "bench":
        jk = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True))
        tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    else:  # not the fused pattern: by-value noise (equality mask), Matern 5/2
        jk = ab.Matern52(2.0, 1.3) + ab.IndependentNoise(0.2)
        tk = pt.Matern52() + pt.IndependentNoise()
    jm = ab.gp_from_covariance(jk, jitter=jitter)
    tm = pt.gp_from_covariance(tk, jitter=jitter)
    tm = params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})
    return jm, tm


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    return (ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y)),
            pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y)))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * np.max(np.abs(b)), np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.mark.parametrize("kind", ["bench", "other"])
@pytest.mark.parametrize("n", [300, 2304, 2113])
def test_log_likelihood_grad_matches_jax(kind, n):
    """Value and gradient of -log_likelihood with respect to the tunable
    vector (length scale, sigma, noise).  n = 2304 and 2113 run the blocked
    loop (2113 with identity padding), which autograd could not
    differentiate while it whitened and inverted in place."""
    jm, tm = _models(kind)
    jd, td = _data(n, seed=n)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    names, values, _, _ = tunable_to_numpy(tm.get_tunable_parameters())
    assert names == jm.get_tunable_parameters().names
    np.testing.assert_allclose(values, x0, rtol=1e-15)

    ref_v, ref_g = jax.value_and_grad(lambda x: -jm.set_tunable_params(x).log_likelihood(jd))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    v = -tm.set_tunable_params(x).log_likelihood(td)
    (g,) = torch.autograd.grad(v, x)
    assert float(v.detach()) == pytest.approx(float(ref_v), rel=RTOL)
    assert g.dtype == torch.float64 and torch.isfinite(g).all()
    _close(g.numpy(), ref_g)


def test_log_likelihood_grad_runs_the_panel_backward():
    """The blocked loop's panels go through the panel Function: one
    backward call per panel (n = 2304 on the CPU pads to 3 panels of
    1024), and no kernel launch on CPU tensors."""
    _, tm = _models("bench")
    _, td = _data(2304)
    _build.reset_launch_counts()
    x = tm.get_tunable_parameters().values.clone().requires_grad_(True)
    (-tm.set_tunable_params(x).log_likelihood(td)).backward()
    assert _build.BACKWARDS["panel_cholinv"] == 3
    assert sum(_build.LAUNCHES.values()) == 0


def _spd(rng, b):
    M = rng.standard_normal((b, b))
    return M @ M.T / b + np.eye(b)


@pytest.mark.parametrize("b", [128, 256])
def test_panel_function_gradcheck(b):
    """gradcheck of the closed-form backward against finite differences of
    the plain forward, f64 (the input symmetrized, as a Cholesky reads one
    triangle)."""
    A = torch.tensor(_spd(np.random.default_rng(b), b), requires_grad=True)

    def fn(A):
        return _PanelCholInv.apply(0.5 * (A + A.T), 256)

    assert torch.autograd.gradcheck(fn, (A,), eps=1e-6, atol=1e-6, rtol=1e-5, fast_mode=True)


@pytest.mark.parametrize("b", [128, 256, 768])
def test_panel_function_vjp_matches_jax(b):
    """(L, L^-1) of a panel: the port's Function against jax.vjp of the JAX
    package's default panel path (builtin Cholesky + blocked_tri_inverse),
    with the same numpy cotangents."""
    rng = np.random.default_rng(b + 1)
    A = _spd(rng, b)
    gL, gW = rng.standard_normal((b, b)), rng.standard_normal((b, b))
    (L_ref, W_ref), vjp = jax.vjp(lambda A: jbc._panel_chol_inverse(A, 256), jnp.asarray(A))
    (gA_ref,) = vjp((jnp.asarray(gL), jnp.asarray(gW)))
    At = torch.tensor(A, requires_grad=True)
    L, W = tbc._panel_chol_inverse(At, 256)
    _close(L.detach().numpy(), L_ref)
    _close(W.detach().numpy(), W_ref)
    (gA,) = torch.autograd.grad((L, W), At, (torch.tensor(gL), torch.tensor(gW)))
    _close(gA.numpy(), gA_ref)
    np.testing.assert_array_equal(gA.numpy(), gA.numpy().T)  # symmetric, as jnp.linalg.cholesky's


def test_panel_function_keeps_f64_and_either_cotangent():
    """On the CPU the panel Function's plain forward keeps f64 (the kernel
    is f32-only); a cotangent on only one output is enough."""
    A = torch.tensor(_spd(np.random.default_rng(5), 128), requires_grad=True)
    U, Wu = panel_cholinv(A)
    assert U.dtype == Wu.dtype == torch.float64
    (gU,) = torch.autograd.grad(U.sum(), A)
    U2, Wu2 = panel_cholinv_function(A, 64)
    (gWu,) = torch.autograd.grad(Wu2.sum(), A)
    assert torch.isfinite(gU).all() and torch.isfinite(gWu).all()
    # against autograd of the same plain forward
    A2 = A.detach().clone().requires_grad_(True)
    L = torch.linalg.cholesky(A2)
    (gU_ref,) = torch.autograd.grad(L.T.sum(), A2)
    _close(gU.numpy(), gU_ref.numpy())


@pytest.mark.parametrize("m", [768, 700])
def test_blocked_tri_inverse_vjp_matches_jax(m):
    """blocked_tri_inverse, now built from whole row blocks, against
    jax.vjp of the JAX package's (m = 700: one triangular solve)."""
    rng = np.random.default_rng(m)
    L = np.linalg.cholesky(_spd(rng, m))
    g = rng.standard_normal((m, m))
    W_ref, vjp = jax.vjp(lambda L: jbc.blocked_tri_inverse(L, 256), jnp.asarray(L))
    (gL_ref,) = vjp(jnp.asarray(g))
    Lt = torch.tensor(L, requires_grad=True)
    W = tbc.blocked_tri_inverse(Lt, 256)
    _close(W.detach().numpy(), W_ref)
    (gL,) = torch.autograd.grad(W, Lt, torch.tensor(g))
    _close(gL.numpy(), gL_ref)


@pytest.mark.parametrize(
    "prior",
    ["gaussian", "positive_gaussian", "log_normal", "uniform", "log_scale_uniform", "positive", "non_negative"],
)
def test_prior_log_pdf_grad_matches_jax(prior):
    """Every prior's log_pdf is differentiable in its value, as the JAX
    package's; the flat priors give 0 (a constant, with no graph)."""
    args = {"gaussian": (0.3, 1.7), "positive_gaussian": (0.3, 1.7), "log_normal": (0.2, 0.8),
            "uniform": (0.0, 4.0), "log_scale_uniform": (1e-2, 1e2)}.get(prior, ())
    name = "".join(w.capitalize() for w in prior.split("_")) + "Prior"
    jp, tp = getattr(ab.core, name)(*args), getattr(pt, name)(*args)
    for value in (0.7, 2.5):
        ref = jax.grad(lambda v: jnp.asarray(jp.log_pdf(v), dtype=jnp.float64))(jnp.float64(value))
        v = torch.tensor(value, dtype=torch.float64, requires_grad=True)
        out = tp.log_pdf(v)
        assert float(out.detach()) == pytest.approx(float(jp.log_pdf(value)), rel=1e-14)
        g = float(torch.autograd.grad(out, v)[0]) if out.requires_grad else 0.0
        assert g == pytest.approx(float(ref), rel=1e-14, abs=1e-300)
