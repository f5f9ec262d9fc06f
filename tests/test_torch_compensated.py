"""Port parity of the double-word arithmetic and the NLML accuracy modes.

The f32 primitives are held against exact arithmetic (numpy f64 for f32
inputs, ``fractions.Fraction`` for f64 inputs), never bit for bit against
the JAX package's f32: XLA:CPU fusion contracts the JAX package's own EFT
chains (its tests/test_compensated.py canary).  The compensated results
are held against the JAX package at f64 (both packages eager or jitted on
the CPU, the same algorithm: 1e-10 relative) and, at f32, against an f64
oracle at the JAX tests' bounds.  The config knobs are set and restored in
both packages in ``try/finally``.
"""

import contextlib
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu.ops.compensated as jc
import albatross_tpu_torch as pt
from albatross_tpu import config as jconfig
from albatross_tpu.ops.linalg import CholeskyFactor as JCholeskyFactor
from albatross_tpu_torch import config as tconfig
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.ops import compensated as tc
from albatross_tpu_torch.ops.linalg import CholeskyFactor

torch.set_num_threads(2)
torch.exp(torch.linspace(-3.0, 0.0, 4096, dtype=torch.float32))  # warm up the f32 exp (ROADMAP watch list)
RTOL = 1e-10


@contextlib.contextmanager
def modes(**settings):
    """Set each config knob in both packages, restoring both after."""
    saved = {k: (getattr(jconfig, k), getattr(tconfig, k)) for k in settings}
    try:
        for k, v in settings.items():
            setattr(jconfig, k, v)
            setattr(tconfig, k, v)
        yield
    finally:
        for k, (jv, tv) in saved.items():
            setattr(jconfig, k, jv)
            setattr(tconfig, k, tv)


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
    assert err <= rtol, err


def _exact(values) -> list:
    return [Fraction(float(v)) for v in np.asarray(values, np.float64).reshape(-1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eft_primitives_exact(dtype):
    """a + b = s + e and a b = p + e exactly, for f32 and f64."""
    rng = np.random.default_rng(1)
    n = 4096 if dtype == torch.float32 else 256
    a = torch.tensor(rng.standard_normal(n) * 1e3, dtype=dtype)
    b = torch.tensor(rng.standard_normal(n), dtype=dtype)
    for fn, op in ((tc.two_sum, lambda x, y: x + y), (tc.two_prod, lambda x, y: x * y)):
        s, e = fn(a, b)
        if dtype == torch.float32:
            np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                          op(a.double().numpy(), b.double().numpy()))
        else:
            got = [x + y for x, y in zip(_exact(s), _exact(e))]
            assert got == [op(x, y) for x, y in zip(_exact(a), _exact(b))]
    xh, xl = tc.two_sum(a, b)
    yh, yl = tc.two_prod(a, b)
    zh, zl = tc.dw_add(xh, xl, yh, yl)
    if dtype == torch.float64:  # the double-word sum of two exact pairs: exact to ~eps^2
        exact = [sh + sl + ph + pl for sh, sl, ph, pl in zip(_exact(xh), _exact(xl), _exact(yh), _exact(yl))]
        got = [h + l for h, l in zip(_exact(zh), _exact(zl))]
        assert max(abs(float((g - x) / x)) for g, x in zip(got, exact) if x != 0) < 1e-28


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dot2_dw_sum_and_dw_matvec(dtype):
    """dot2 on an odd length (the pad to a power of two), dw_sum along an
    axis and dw_matvec chunked and in one block: within eps^2-class error
    of exact arithmetic, and far closer than the plain product."""
    rng = np.random.default_rng(2)
    n = 100001 if dtype == torch.float32 else 1001
    x = torch.tensor(rng.standard_normal(n) * 1e3, dtype=dtype)
    y = torch.tensor(rng.standard_normal(n), dtype=dtype)
    h, l = tc.dot2(x, y)
    if dtype == torch.float32:
        exact = x.double().numpy() @ y.double().numpy()
        got = float(h) + float(l)
        assert abs(got - exact) / abs(exact) < 1e-12
        assert abs(got - exact) < abs(float(x @ y) - exact) / 100.0
    else:
        exact = sum(a * b for a, b in zip(_exact(x), _exact(y)))
        assert abs(float((Fraction(float(h)) + Fraction(float(l)) - exact) / exact)) < 1e-28
    M = torch.tensor(rng.standard_normal((2048, 256)), dtype=dtype)
    K = M.T @ M
    K = torch.cat([K] * 8)  # (2048, 256): 2 chunks of 1024 rows
    v = torch.tensor(rng.standard_normal(256) * 100, dtype=dtype)
    p, e = tc.two_prod(K, v[None, :])
    sh, sl = tc.dw_sum(p, e, dim=1)
    for chunk in (1024, 1000):  # 1000 does not divide 2048: one block
        hh, hl = tc.dw_matvec(K, v, chunk=chunk)
        assert torch.equal(hh, sh) and torch.equal(hl, sl)
    if dtype == torch.float32:
        exact = K.double().numpy() @ v.double().numpy()
        np.testing.assert_allclose(hh.double().numpy() + hl.double().numpy(), exact, rtol=1e-12)
    else:
        row = [a * b for a, b in zip(_exact(K[0]), _exact(v))]
        assert abs(float((Fraction(float(hh[0])) + Fraction(float(hl[0])) - sum(row)) / sum(row))) < 1e-28


def test_accurate_log_guarded_domain_matches_jax():
    """Finite positive normals take the double-word log; 0, negatives,
    NaN, inf and subnormals the builtin's values, as in the JAX package."""
    x = np.array([0.5, 2.0, 1e-30, 0.0, -1.0, np.nan, np.inf, 1e-40, 3.0e38], np.float32)
    h, l = tc.accurate_log_guarded(torch.tensor(x))
    jh, jl = jc.accurate_log_guarded(jnp.asarray(x))
    np.testing.assert_array_equal(np.isnan(h.numpy()), np.isnan(np.asarray(jh)))
    finite = np.isfinite(np.asarray(jh))
    special = ~finite & ~np.isnan(x) & (x != 1e-40)
    np.testing.assert_array_equal(h.numpy()[special], np.asarray(jh)[special])
    # a subnormal takes each backend's builtin log (XLA:CPU flushes it to 0)
    assert h[7] == torch.log(torch.tensor(x[7])) and l[7] == 0.0
    finite[7] = False
    exact = np.log(x[finite].astype(np.float64))
    got = h.numpy()[finite].astype(np.float64) + l.numpy()[finite].astype(np.float64)
    assert np.max(np.abs(got - exact) / np.maximum(np.abs(exact), 1.0)) < np.finfo(np.float32).eps
    assert l.numpy()[~finite].tolist() == [0.0] * int((~finite).sum())


def _problem(n, seed, dtype=np.float64, ls=5.0, nugget=1e-3):
    """An SE covariance with a nugget on n sorted points of [0, 100] and
    sin targets, in ``dtype``; returned with its f64 copy."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    K = np.exp(-0.5 * ((x[:, None] - x[None, :]) / ls) ** 2) + nugget * np.eye(n)
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    K, y = K.astype(dtype), y.astype(dtype)
    return K, y, K.astype(np.float64), y.astype(np.float64)


def test_refined_quadratic_log_determinant_and_nll_match_jax_f64():
    """refined_quadratic (0 and 2 steps), dw_log_determinant and
    compensated_nll(_dw) at f64 against the JAX package, n = 512."""
    K, y, _, _ = _problem(512, 3)
    tchol = CholeskyFactor.factorize(torch.tensor(K), assume_symmetric=True)
    jchol = JCholeskyFactor.factorize(jnp.asarray(K), assume_symmetric=True)
    Kt, yt, Kj, yj = torch.tensor(K), torch.tensor(y), jnp.asarray(K), jnp.asarray(y)
    for steps in (0, 2):
        got = tc.refined_quadratic(tchol, Kt, yt, refine_steps=steps)
        ref = jc.refined_quadratic(jchol, Kj, yj, refine_steps=steps)
        _close(float(got[0]) + float(got[1]), float(ref[0]) + float(ref[1]))
    got, ref = tc.dw_log_determinant(tchol.L), jc.dw_log_determinant(jchol.L)
    _close(float(got[0]) + float(got[1]), float(ref[0]) + float(ref[1]))
    h, l = tc.compensated_nll_dw(tchol, Kt, yt)
    rh, rl = jc.compensated_nll_dw(jchol, Kj, yj)
    _close(float(h) + float(l), float(rh) + float(rl))
    _close(float(tc.compensated_nll(tchol, Kt, yt)), float(jc.compensated_nll(jchol, Kj, yj)))


@pytest.mark.parametrize("n", [1024, 1000])
def test_blocked_cholesky_dw_matches_jax_f64(n):
    """The factor, the whitened vector and the log-det of
    blocked_cholesky_dw at block_size=256 (1000: padded to 1024) against
    the JAX package at f64; assemble=False gives the same diagonal and
    vector."""
    K, y, _, _ = _problem(n, 4, ls=3.0, nugget=1e-2)
    L, z = tc.blocked_cholesky_dw(torch.tensor(K), block_size=256, rhs=torch.tensor(y))
    Lr, zr = jc.blocked_cholesky_dw(jnp.asarray(K), block_size=256, rhs=jnp.asarray(y))
    _close(L.numpy(), Lr)
    _close(z.numpy(), zr)
    assert L.shape == (n, n) and torch.equal(L, torch.tril(L))
    d, z2 = tc.blocked_cholesky_dw(torch.tensor(K), block_size=256, rhs=torch.tensor(y), assemble=False)
    assert torch.equal(d, torch.diagonal(L)) and torch.equal(z2, z)
    _close(2.0 * float(tc.accurate_sum_of_logs(d)), 2.0 * np.sum(np.log(np.diag(np.asarray(Lr)))))
    with pytest.raises(ValueError, match="requires rhs"):
        tc.blocked_cholesky_dw(torch.tensor(K), block_size=256, assemble=False)


def test_f32_accuracy_against_the_f64_oracle():
    """At f32 (the JAX tests' bounds, tests/test_compensated.py): the
    compensated NLML within 2e-6 of the f64 oracle and at least 10x closer
    than the plain f32 pipeline; two refinement steps 5x better than none;
    the dw log-det of the f32 factor within 1e-9 of its exact logs; the
    double-word factorization's log-det within 1e-7 of the f64 factor's."""
    n = 1024
    K32, y32, K64, y64 = _problem(n, 5, dtype=np.float32)
    L64 = np.linalg.cholesky(K64)
    w64 = np.linalg.solve(L64, y64)
    nll64 = 0.5 * (2.0 * np.sum(np.log(np.diag(L64))) + w64 @ w64 + n * math.log(2.0 * math.pi))
    Kt, yt = torch.tensor(K32), torch.tensor(y32)
    chol = CholeskyFactor.factorize(Kt, assume_symmetric=True)
    white = chol.sqrt_solve(yt)
    plain = float(0.5 * (chol.log_determinant() + torch.sum(white * white) + n * math.log(2.0 * math.pi)))
    comp = float(tc.compensated_nll(chol, Kt, yt))
    plain_err, err = abs(plain - nll64) / abs(nll64), abs(comp - nll64) / abs(nll64)
    assert err < 2e-6 and err < plain_err / 10.0, (err, plain_err)
    q_exact = y64 @ np.linalg.solve(K64, y64)
    errs = [abs(sum(map(float, tc.refined_quadratic(chol, Kt, yt, refine_steps=s))) - q_exact) / q_exact
            for s in (0, 2)]
    assert errs[1] < 1e-6 and errs[1] < errs[0] / 5.0, errs
    h, l = tc.dw_log_determinant(chol.L)
    exact = 2.0 * np.sum(np.log(np.diag(chol.L.double().numpy())))
    assert abs(float(h) + float(l) - exact) / abs(exact) < 1e-9
    L, _ = tc.blocked_cholesky_dw(Kt, block_size=256, rhs=torch.ones(n))
    L64dw = L.double().numpy()
    assert np.linalg.norm(K64 - L64dw @ L64dw.T) / np.linalg.norm(K64) < 1e-6
    oracle = 2.0 * np.sum(np.log(np.diag(L64)))
    assert abs(2.0 * np.sum(np.log(np.diag(L64dw))) - oracle) / abs(oracle) < 1e-7


def _models(n, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    jk = ab.SquaredExponential(5.0, 1.0) + ab.measurement_only(ab.IndependentNoise(0.1, assume_unique=True))
    jm = ab.gp_from_covariance(jk, jitter=1e-6)
    tm = pt.gp_from_covariance(pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True)),
                               jitter=1e-6)
    tm = params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})
    return (jm, ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y)),
            tm, pt.RegressionDataset.create(torch.tensor(x), torch.tensor(y)))


MODES = {
    "compensated": dict(NLML_COMPENSATED=True),
    "double_word": dict(CHOLESKY_PRECISION="double_word"),
    "both": dict(NLML_COMPENSATED=True, CHOLESKY_PRECISION="double_word"),
    "high": dict(CHOLESKY_PRECISION="high"),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_log_likelihood_modes_match_jax(mode):
    """log_likelihood under each mode against the JAX package under the
    same settings, f64, n = 2304 (the blocked loop, padded to 3 panels of
    1024); "high" takes the port's default path."""
    jm, jd, tm, td = _models(2304, 6)
    with modes(**MODES[mode]):
        got = float(tm.log_likelihood(td))
        ref = float(jm.log_likelihood(jd))
    assert got == pytest.approx(ref, rel=RTOL)
    assert got == pytest.approx(float(tm.log_likelihood(td)), rel=1e-9)  # every mode: the same value in f64


@pytest.mark.parametrize("mode", ["compensated", "double_word"])
def test_gradient_under_the_modes_matches_jax(mode):
    """The tuning loop's gradient (set_tunable_params, autograd) under each
    mode against jax.grad of the JAX package's, f64, n = 2304."""
    jm, jd, tm, td = _models(2304, 7)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    with modes(**MODES[mode]):
        ref_v, ref_g = jax.value_and_grad(lambda x: -jm.set_tunable_params(x).log_likelihood(jd))(jnp.asarray(x0))
        x = torch.tensor(x0, requires_grad=True)
        v = -tm.set_tunable_params(x).log_likelihood(td)
        (g,) = torch.autograd.grad(v, x)
    assert float(v.detach()) == pytest.approx(float(ref_v), rel=RTOL)
    assert torch.isfinite(g).all()
    _close(g.numpy(), ref_g, rtol=1e-9)


def test_factorize_and_nlml_terms_route_through_double_word():
    """Above n = 2048 CholeskyFactor takes blocked_cholesky_dw under
    "double_word": the factor equals a direct call's, and nlml_terms' log
    det and vector its assemble=False outputs."""
    K, y, _, _ = _problem(2304, 8)
    Kt, yt = torch.tensor(K), torch.tensor(y)
    with modes(CHOLESKY_PRECISION="double_word"):
        chol = CholeskyFactor.factorize(Kt, assume_symmetric=True)
        ld, white = CholeskyFactor.nlml_terms(Kt, yt, assume_symmetric=True)
    assert torch.equal(chol.L, tc.blocked_cholesky_dw(Kt))
    d, z = tc.blocked_cholesky_dw(Kt, rhs=yt, assemble=False)
    assert torch.equal(white, z) and torch.equal(ld, 2.0 * tc.accurate_sum_of_logs(d))


def test_config_errors():
    """col_fn with "double_word" raises the JAX package's ValueError; an
    unknown precision and a block size off the 128 grid raise; a set block
    size is honoured."""
    _, _, tm, td = _models(64, 9)
    with modes(CHOLESKY_PRECISION="double_word"):
        with pytest.raises(ValueError, match="incompatible with CHOLESKY_PRECISION='double_word'"):
            CholeskyFactor.nlml_terms(None, td.targets.mean, col_fn=lambda j0, b: None)
    with modes(CHOLESKY_PRECISION="quad"), pytest.raises(ValueError, match="unknown CHOLESKY_PRECISION"):
        tm.log_likelihood(td)
    from albatross_tpu_torch.ops.blocked_cholesky import default_block_size

    with modes(CHOLESKY_BLOCK_SIZE=200), pytest.raises(ValueError, match="multiple of 128"):
        default_block_size(4096, torch.device("cpu"))
    with modes(CHOLESKY_BLOCK_SIZE=2048):
        assert default_block_size(4096, torch.device("cpu")) == 2048
        with pytest.raises(ValueError, match="MAX_CUDA_PANEL"):
            default_block_size(4096, torch.device("cuda"), torch.float32)
        assert default_block_size(4096, torch.device("cuda"), torch.float64) == 2048


def test_dw_sum_takes_the_reference_axis_keyword():
    """dw_sum(hi, lo, axis=1) as the reference calls it (torch's dim= is
    kept beside it), against the JAX package at f64."""
    rng = np.random.default_rng(31)
    hi, lo = rng.standard_normal((3, 37)), 1e-17 * rng.standard_normal((3, 37))
    want = jc.dw_sum(jnp.asarray(hi), jnp.asarray(lo), axis=1)
    for got in (tc.dw_sum(torch.tensor(hi), torch.tensor(lo), axis=1),
                tc.dw_sum(torch.tensor(hi), torch.tensor(lo), 1),
                tc.dw_sum(torch.tensor(hi), torch.tensor(lo), dim=1)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=1e-30)
    h0, l0 = tc.dw_sum(torch.tensor(hi), axis=0)
    assert h0.shape == (37,) and l0.shape == (37,)


def test_accurate_log_vmap_runs_its_forward_on_the_whole_batch(monkeypatch):
    """torch.func.vmap hands accurate_log's forward the batch as a plain
    tensor: a batched tensor there needs a batching rule for
    ``Tensor.view(dtype)``, which torch 2.11 lacks, and the f32
    cross-validation scores then fell back to one fold at a time.  Values
    and gradient equal the unbatched call's."""
    from torch._C._functorch import is_batchedtensor

    real = tc._accurate_log_values

    def checked(x):
        if is_batchedtensor(x):
            raise AssertionError("accurate_log's forward was handed a batched tensor")
        return real(x)

    monkeypatch.setattr(tc, "_accurate_log_values", checked)
    x = 0.5 + torch.rand((5, 7), generator=torch.Generator().manual_seed(0))
    h, l = torch.func.vmap(tc.accurate_log)(x)
    h0, l0 = real(x)
    assert torch.equal(h, h0) and torch.equal(l, l0)
    xr = x.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(torch.func.vmap(tc.accurate_log)(xr)[0].sum(), xr)
    assert torch.equal(grad, 1.0 / x)


def test_f32_loo_likelihood_scores_every_fold_in_one_batch(monkeypatch):
    """The LOO likelihood of an f32 model takes the batched scores (one
    vmap over the folds), never the fold-by-fold loop."""
    from albatross_tpu_torch.evaluation import LeaveOneOutLikelihood
    from albatross_tpu_torch.evaluation import cross_validation

    def fold_by_fold(*args):
        raise AssertionError("the scores fell back to one fold at a time")

    monkeypatch.setattr(cross_validation, "cross_validated_scores", fold_by_fold)
    x = np.sort(np.random.default_rng(0).uniform(0.0, 10.0, 48))
    data = pt.RegressionDataset.create(x, np.sin(x), device="cpu", dtype=torch.float32)
    model = pt.gp_from_covariance(pt.SquaredExponential(1.0, 1.0) + pt.measurement_only(pt.IndependentNoise(0.1)))
    assert torch.isfinite(LeaveOneOutLikelihood()(data, model))
