"""Port parity of the distributions' arithmetic and linear transforms
against the JAX package, f64 on the CPU at 1e-12 relative (the same few
products on both sides), as tests/test_distributions.py holds the JAX
package's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt

torch.set_num_threads(2)
RTOL = 1e-12


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=RTOL * np.max(np.abs(np.asarray(want))))


def _same(got, want):
    """A port distribution against a JAX one: same class name, same values."""
    assert type(got).__name__ == type(want).__name__
    _close(got.mean, want.mean)
    if isinstance(want, ab.JointDistribution):
        _close(got.covariance, want.covariance)
    else:
        _close(got.get_variance(), want.get_variance())


def _pair(rng, n=5):
    mean, var = rng.standard_normal(n), rng.uniform(0.5, 2.0, n)
    C = rng.standard_normal((n, n))
    C = C @ C.T + n * np.eye(n)
    return {
        "marginal": (pt.MarginalDistribution.create(torch.tensor(mean), torch.tensor(var)),
                     ab.MarginalDistribution.create(jnp.asarray(mean), jnp.asarray(var))),
        "joint": (pt.JointDistribution.create(torch.tensor(mean), torch.tensor(C)),
                  ab.JointDistribution.create(jnp.asarray(mean), jnp.asarray(C))),
    }


def test_the_reference_values_of_the_repro():
    m = pt.MarginalDistribution.create(torch.tensor([1.0, 2.0], dtype=torch.float64),
                                       torch.tensor([1.0, 4.0], dtype=torch.float64))
    A = [[1.0, 1.0], [1.0, -1.0]]
    jm = ab.MarginalDistribution.create(jnp.asarray([1.0, 2.0]), jnp.asarray([1.0, 4.0]))
    _close((np.asarray(A) @ m).covariance, [[5.0, -3.0], [-3.0, 5.0]])
    _close(m.transform_marginal(A).variance, [5.0, 5.0])
    _close((m + m).mean, [2.0, 4.0])
    _same(np.asarray(A) @ m, jnp.asarray(A) @ jm)
    _same(m.transform_marginal(A), jm.transform_marginal(jnp.asarray(A)))
    _same(m + m, jm + jm)


@pytest.mark.parametrize("kind", ["marginal", "joint"])
@pytest.mark.parametrize("op", ["add", "sub", "add_other_kind", "sub_other_kind", "mul", "rmul", "neg_scale"])
def test_arithmetic_matches_jax(kind, op):
    rng = np.random.default_rng(11)
    a, b = _pair(rng), _pair(rng)
    (t, j), (t2, j2) = a[kind], b[kind]
    if op.endswith("other_kind"):
        if kind == "marginal":  # a marginal adds only marginals, in both packages
            with pytest.raises(AttributeError):
                t + b["joint"][0]
            return
        t2, j2 = b["marginal"]
    apply = {"add": lambda x, y: x + y, "sub": lambda x, y: x - y, "add_other_kind": lambda x, y: x + y,
             "sub_other_kind": lambda x, y: x - y, "mul": lambda x, y: x * 2.5, "rmul": lambda x, y: 2.5 * x,
             "neg_scale": lambda x, y: -0.5 * x}[op]
    _same(apply(t, t2), apply(j, j2))


@pytest.mark.parametrize("kind", ["marginal", "joint"])
@pytest.mark.parametrize("left", ["tensor", "numpy", "list"])
def test_matrix_on_the_left_of_matmul(kind, left):
    """A tensor, a numpy matrix and a nested list all reach __rmatmul__
    (numpy through __array_ufunc__ = None) and give the JAX package's
    transform."""
    rng = np.random.default_rng(12)
    t, j = _pair(rng)[kind]
    A = rng.standard_normal((3, 5))
    lhs = {"tensor": torch.tensor(A), "numpy": A, "list": A.tolist()}[left]
    got = lhs @ t
    assert isinstance(got, pt.JointDistribution)
    _same(got, jnp.asarray(A) @ j)
    _same(t.transform(lhs), j.transform(jnp.asarray(A)))
    _same(t.transform_marginal(lhs), j.transform_marginal(jnp.asarray(A)))


def test_marginal_set_subset_and_covariance_diagonal():
    rng = np.random.default_rng(13)
    t, j = _pair(rng, 6)["marginal"]
    idx = [4, 1]
    new_t = pt.MarginalDistribution.create(torch.tensor([9.0, -9.0], dtype=torch.float64),
                                           torch.tensor([0.9, 0.7], dtype=torch.float64))
    new_j = ab.MarginalDistribution.create(jnp.asarray([9.0, -9.0]), jnp.asarray([0.9, 0.7]))
    _same(t.set_subset(idx, new_t), j.set_subset(jnp.asarray(idx), new_j))
    _same(t.set_subset(np.array([True, False, False, True, False, False]), new_t),
          j.set_subset(jnp.asarray([True, False, False, True, False, False]), new_j))
    _close(t.covariance_diagonal, j.covariance_diagonal)
    no_var = pt.MarginalDistribution.create(torch.tensor([1.0, 2.0], dtype=torch.float64))
    _close(no_var.covariance_diagonal, [0.0, 0.0])
    _close(no_var.set_subset([0], new_t.subset([0])).variance, [0.9, 0.0])
    # out of place: the original is untouched
    _close(t.mean, j.mean)


def test_transforms_are_differentiable():
    """The transforms are torch ops: a gradient reaches the mean, the
    variance and the matrix."""
    mean = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    var = torch.tensor([1.0, 4.0], dtype=torch.float64, requires_grad=True)
    A = torch.tensor([[1.0, 1.0], [1.0, -1.0]], dtype=torch.float64, requires_grad=True)
    out = (A @ pt.MarginalDistribution(mean, var)).covariance.sum() + pt.MarginalDistribution(
        mean, var).transform_marginal(A).mean.sum()
    gm, gv, gA = torch.autograd.grad(out, (mean, var, A))
    _close(gv, [4.0, 0.0])  # sum_ik A_ij A_kj = (sum_i A_ij)^2
    _close(gm, [2.0, 0.0])
    assert torch.isfinite(gA).all()
