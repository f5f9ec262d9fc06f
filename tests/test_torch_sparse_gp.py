"""Port parity of the sparse GP (FITC / PITC, ``models/sparse_gp.py``).

The same numpy data go through the JAX package's SparseGaussianProcessRegression
and the port's at f64 on the CPU.  QR signs may differ between the two, so
the tests compare what does not depend on them: v, the predictions, the
NLML (|diag R|) and its gradient.  Values agree to 1e-9 relative to the
largest entry and gradients to 1e-8 (f64 rounding of small problems whose
inducing grams are conditioned below ~1e6).  Comparisons against a full
fit or a dense GP keep the JAX tests' own tolerances
(tests/test_sparse_gp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.indexing import KFoldGrouper as JKFoldGrouper
from albatross_tpu.models.base import Prediction as JPrediction
from albatross_tpu.models.sparse_gp import EveryPointGrouper as JEveryPointGrouper
from albatross_tpu_torch import _build
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.indexing import KFoldGrouper
from albatross_tpu_torch.models.base import Prediction
from albatross_tpu_torch.models.sparse_gp import EveryPointGrouper, SparseGPFit
from albatross_tpu_torch.ops.block import BlockDiagonalCholesky, DiagonalCholesky

torch.set_num_threads(2)
RTOL = 1e-9
GRAD_RTOL = 1e-8
N = 36  # one training size where the test allows: the JAX package compiles each shape once


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
    assert err <= rtol, err


def _ragged(features):
    """Groups by floor(x / 2.6): four groups of ragged sizes."""
    return np.floor(np.asarray(features) / 2.6).astype(np.int64)


GROUPERS = {
    "fitc": (JEveryPointGrouper, EveryPointGrouper),
    "kfold": (lambda: JKFoldGrouper(6), lambda: KFoldGrouper(6)),
    "ragged": (lambda: _ragged, lambda: lambda f: _ragged(f.cpu().numpy())),
}


def _models(grouper="fitc", inducing=None, num_inducing=8, ls=2.0):
    jg, tg = GROUPERS[grouper]
    j_ind, t_ind = inducing or (ab.UniformlySpacedInducingPoints(num_inducing),
                                pt.UniformlySpacedInducingPoints(num_inducing))
    jm = ab.sparse_gp_from_covariance(ab.SquaredExponential(ls, 1.0) + ab.measurement_only(ab.IndependentNoise(0.1)),
                                      grouper=jg(), inducing_point_strategy=j_ind)
    tm = pt.sparse_gp_from_covariance(pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise()),
                                      grouper=tg(), inducing_point_strategy=t_ind)
    return jm, params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _data(n, seed, lo=0.0, hi=10.0):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(lo, hi, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    var = np.full(n, 0.01)
    return (ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jnp.asarray(var)),
            pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=torch.as_tensor(var)))


def _check_predictions(jfit, tfit, xs, rtol=RTOL):
    jp, tp = jfit.predict(jnp.asarray(xs)), tfit.predict(torch.as_tensor(xs))
    _close(tp.mean(), jp.mean(), rtol)
    jm, tm = jp.marginal(), tp.marginal()
    _close(tm.mean, jm.mean, rtol)
    _close(tm.variance, jm.variance, rtol)
    jj, tj = jp.joint(), tp.joint()
    _close(tj.mean, jj.mean, rtol)
    _close(tj.covariance, jj.covariance, rtol)


@pytest.mark.parametrize("grouper", sorted(GROUPERS))
def test_sparse_fit_and_predictions_match_jax(grouper):
    jm, tm = _models(grouper)
    jd, td = _data(N, seed=len(grouper))
    jfit, tfit = jm.fit(jd), tm.fit(td)
    assert isinstance(tfit.fit, SparseGPFit)
    assert tfit.fit.numerical_rank == jfit.fit.numerical_rank == 8
    _close(tfit.fit.information, jfit.fit.information)
    # R up to the signs of its rows
    _close(torch.abs(tfit.fit.R), np.abs(np.asarray(jfit.fit.R)))
    _check_predictions(jfit, tfit, np.linspace(-0.5, 10.5, 9))


@pytest.mark.parametrize("grouper", sorted(GROUPERS))
def test_sparse_log_likelihood_and_gradient_match_jax(grouper):
    """-log_likelihood and its gradient with respect to the tunable vector,
    the two nuggets included, against jax.value_and_grad."""
    jm, tm = _models(grouper)
    jd, td = _data(N, seed=7 + len(grouper))
    names = jm.get_tunable_parameters().names
    assert names == tm.get_tunable_parameters().names
    assert "measurement_nugget" in names and "inducing_nugget" in names
    assert float(tm.log_likelihood(td)) == pytest.approx(float(jm.log_likelihood(jd)), rel=RTOL)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    ref_v, ref_g = jax.value_and_grad(lambda x: -jm.set_tunable_params(x).log_likelihood(jd))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    v = -tm.set_tunable_params(x).log_likelihood(td)
    (g,) = torch.autograd.grad(v, x)
    assert float(v.detach()) == pytest.approx(float(ref_v), rel=RTOL)
    _close(g, ref_g, GRAD_RTOL)


def test_fitc_and_pitc_factor_types():
    _, fitc = _models("fitc")
    _, pitc = _models("ragged")
    _, td = _data(30, seed=3)
    u = pt.UniformlySpacedInducingPoints(6)(None, td.features)
    A_fitc = fitc._compute_internal_components(u, td.features, td.targets)[0]
    A_pitc = pitc._compute_internal_components(u, td.features, td.targets)[0]
    assert isinstance(A_fitc, DiagonalCholesky)
    assert isinstance(A_pitc, BlockDiagonalCholesky) and len(set(A_pitc.sizes)) > 1


class _FixedInducing:
    """The same grid for both fits (UniformlySpacedInducingPoints would
    derive different grids from different feature ranges)."""

    def __init__(self, lib):
        self.lib = lib

    def __call__(self, cov, features):
        if self.lib is jnp:
            return jnp.linspace(0.0, 10.0, 10)
        return torch.linspace(0.0, 10.0, 10, dtype=torch.float64)


@pytest.mark.parametrize("grouper", ["fitc", "kfold"])
def test_sparse_update_matches_jax_and_a_full_fit(grouper):
    jm, tm = _models(grouper, inducing=(_FixedInducing(jnp), _FixedInducing(torch)))
    jd, td = _data(30, seed=11)
    j_split = jm.fit(jd[jnp.arange(20)]).update(jd[jnp.arange(20, 30)])
    t_split = tm.fit(td[np.arange(20)]).update(td[np.arange(20, 30)])
    xs = np.linspace(0.5, 9.5, 9)
    _check_predictions(j_split, t_split, xs)
    full = tm.fit(td).predict(torch.as_tensor(xs)).marginal()
    split = t_split.predict(torch.as_tensor(xs)).marginal()
    if grouper == "fitc":  # the JAX test's tolerances; PITC's k-fold groups differ in a split
        np.testing.assert_allclose(split.mean.numpy(), full.mean.numpy(), rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(split.variance.numpy(), full.variance.numpy(), rtol=1e-5, atol=1e-8)
    assert t_split.for_serving() is t_split  # sparse fits have no explicit-inverse form


def test_rebase_inducing_points_matches_jax():
    jm, tm = _models(num_inducing=12)
    jd, td = _data(N, seed=13)
    new_u = np.linspace(0.0, 10.0, 15)
    j_re = ab.rebase_inducing_points(jm.fit(jd), jnp.asarray(new_u))
    t_fit = tm.fit(td)
    t_re = pt.rebase_inducing_points(t_fit, torch.as_tensor(new_u))
    assert t_re.fit.numerical_rank == j_re.fit.numerical_rank
    xs = np.linspace(1.0, 9.0, 9)
    _check_predictions(j_re, t_re, xs, rtol=1e-8)
    before = t_fit.predict(torch.as_tensor(xs)).marginal()
    after = t_re.predict(torch.as_tensor(xs)).marginal()
    np.testing.assert_allclose(after.mean.numpy(), before.mean.numpy(), atol=2e-3)
    np.testing.assert_allclose(after.variance.numpy(), before.variance.numpy(), atol=5e-3)


def test_shift_mean_matches_jax():
    jm, tm = _models()
    jd, td = _data(N, seed=17)
    jfit, tfit = jm.fit(jd).fit, tm.fit(td).fit
    shift = 2.0 * np.ones(8)
    jshift, tshift = jfit.shift_mean(jnp.asarray(shift)), tfit.shift_mean(torch.as_tensor(shift))
    _close(tshift.information, jshift.information)
    xs = np.linspace(1.0, 9.0, 5)
    shifted = Prediction(tm, tshift, torch.as_tensor(xs)).mean()
    _close(shifted, JPrediction(jm, jshift, jnp.asarray(xs)).mean())
    assert torch.all(shifted > Prediction(tm, tfit, torch.as_tensor(xs)).mean())


@pytest.mark.parametrize("kernel", ["squared_exponential", "exponential", "sum", "matern_32"])
def test_state_space_grid_matches_jax(kernel):
    """The radial kernels' grids (10 points a length scale for the squared
    exponential, 20 for the exponential, none for the Materns), a sum's
    concatenation, and the strategy's fit."""
    x = np.sort(np.random.default_rng(19).uniform(0.0, 10.0, 20))
    jk, tk = {
        "squared_exponential": (ab.SquaredExponential(3.0, 1.0), pt.SquaredExponential(3.0, 1.0)),
        "exponential": (ab.Exponential(4.0, 1.0), pt.Exponential(4.0, 1.0)),
        "sum": (ab.SquaredExponential(3.0, 1.0) + ab.Exponential(5.0, 1.0),
                pt.SquaredExponential(3.0, 1.0) + pt.Exponential(5.0, 1.0)),
        "matern_32": (ab.Matern32(3.0, 1.0), pt.Matern32(3.0, 1.0)),
    }[kernel]
    j_grid, t_grid = jk.state_space_representation(jnp.asarray(x)), tk.state_space_representation(torch.as_tensor(x))
    if kernel == "matern_32":
        assert j_grid is None and t_grid is None
        with pytest.raises(TypeError, match="state_space_representation"):
            pt.StateSpaceInducingPointStrategy()(tk, torch.as_tensor(x))
        return
    assert t_grid.dtype == torch.float64
    _close(t_grid, j_grid, rtol=1e-15)


def test_state_space_strategy_fit_matches_jax():
    """SquaredExponential's grid: h = l / 10, an inducing gram that only f64
    factors (f32 fails at this spacing on any device)."""
    jm, tm = _models(inducing=(ab.StateSpaceInducingPointStrategy(), pt.StateSpaceInducingPointStrategy()),
                     ls=3.0)
    jd, td = _data(20, seed=23)
    jfit, tfit = jm.fit(jd), tm.fit(td)
    assert tfit.fit.train_features.shape[0] >= 3
    _close(tfit.fit.train_features, jfit.fit.train_features, rtol=1e-15)
    _check_predictions(jfit, tfit, np.linspace(1.0, 9.0, 5), rtol=1e-7)


@pytest.mark.parametrize("length_scale, hi", [(3.0, 10.0), (0.5, 100.0)])
def test_state_space_grid_inducing_gram_factors_in_f64_only(length_scale, hi):
    """SquaredExponential's grid puts 10 inducing points a length scale
    (h = l / 10): its gram plus the default inducing nugget factors in f64
    but not in f32, whatever the device, a property of the JAX package's
    design that keeps StateSpaceInducingPointStrategy an f64 strategy."""
    kernel = pt.SquaredExponential(length_scale, 1.0)
    u = kernel.state_space_representation(torch.linspace(0.0, hi, 200, dtype=torch.float64))
    K = kernel(u) + 1e-8 * torch.eye(u.shape[0], dtype=torch.float64)
    assert torch.linalg.cholesky_ex(K).info == 0
    assert torch.linalg.cholesky_ex(K.float()).info > 0


def test_fitc_f32_coincident_inducing_point_finite():
    """In f32 an inducing point that coincides with a training point (the
    uniform grid's end points always do) cancels the FITC residual to ~0;
    the rounding-scale clamp keeps the NLML, fit and predictions finite."""
    rng = np.random.default_rng(29)
    x = torch.as_tensor(np.sort(rng.uniform(0, 10, 300)), dtype=torch.float32)
    torch.exp(x)  # warm up the f32 exp (the first multi-threaded call)
    data = pt.RegressionDataset.create(x, torch.sin(x))
    model = pt.sparse_gp_from_covariance(pt.SquaredExponential(2.0, 1.0) + pt.IndependentNoise(0.1),
                                         inducing_point_strategy=pt.UniformlySpacedInducingPoints(32))
    assert torch.isfinite(model.log_likelihood(data))
    xs = torch.linspace(0, 10, 20, dtype=torch.float32)
    pred = model.fit(data).predict(xs).marginal()
    assert pred.mean.dtype == torch.float32
    assert torch.isfinite(pred.mean).all() and torch.isfinite(pred.variance).all()
    assert float(torch.sqrt(torch.mean((pred.mean - torch.sin(xs)) ** 2))) < 0.05


def test_blocked_inducing_gram_matches_jax():
    """M = 2304 inducing points: K_uu goes through the blocked column-panel
    loop in both packages (M > 2048); h = 0.043 under l = 0.05 keeps K_uu
    well conditioned.  No kernel launches on CPU tensors."""
    inducing = (ab.UniformlySpacedInducingPoints(2304), pt.UniformlySpacedInducingPoints(2304))
    jm, tm = _models(inducing=inducing, ls=0.05)
    jd, td = _data(400, seed=31, hi=100.0)
    _build.reset_launch_counts()
    jfit, tfit = jm.fit(jd), tm.fit(td)
    assert tfit.fit.train_covariance.L.shape == (2304, 2304)
    _check_predictions(jfit, tfit, np.linspace(0.0, 100.0, 11), rtol=1e-8)
    assert float(tm.log_likelihood(td)) == pytest.approx(float(jm.log_likelihood(jd)), rel=RTOL)
    assert sum(_build.LAUNCHES.values()) == 0


def test_sparse_converges_to_dense():
    """With inducing points at many times the training density, FITC is the
    exact GP (the JAX test's tolerances)."""
    jm, tm = _models(num_inducing=60)
    _, td = _data(30, seed=37)
    dense = pt.gp_from_covariance(pt.SquaredExponential(2.0, 1.0) + pt.measurement_only(pt.IndependentNoise(0.1)))
    xs = torch.linspace(0.5, 9.5, 11, dtype=torch.float64)
    d = dense.fit(td).predict(xs).marginal()
    s = tm.fit(td).predict(xs).marginal()
    assert float(torch.max(torch.abs(s.mean - d.mean))) < 5e-3
    np.testing.assert_allclose(s.variance.numpy(), d.variance.numpy(), atol=5e-3)


def test_sparse_fit_from_prediction_and_factories():
    jm, tm = _models()
    jd, td = _data(N, seed=41)
    u = np.linspace(0.0, 10.0, 9)
    jpred = jm.fit(jd).predict(jnp.asarray(u)).joint()
    tpred = tm.fit(td).predict(torch.as_tensor(u)).joint()
    j_fit = jm.fit_from_prediction(jnp.asarray(u), jpred)
    t_fit = tm.fit_from_prediction(torch.as_tensor(u), tpred)
    _check_predictions(j_fit, t_fit, np.linspace(0.5, 9.5, 7), rtol=1e-8)
    model = pt.sparse_gp_from_covariance_and_mean(pt.SquaredExponential(), pt.ZeroMean(), model_name="s")
    assert model.model_name == "s" and isinstance(model.grouper, EveryPointGrouper)
    assert model.set_param_value("measurement_nugget", 1e-4).get_param_value("measurement_nugget") == 1e-4


def test_f32_tall_qr_runs_in_f64(monkeypatch):
    """An f32 fit and log_likelihood take the tall QR in f64 (cuSOLVER's
    f32 QR is inaccurate on tall matrices) and keep R, v and the
    predictions in f32, within 1e-4 of the same fit in f64."""
    seen = []
    qr = torch.linalg.qr

    def recording_qr(B, mode="reduced"):
        seen.append(B.dtype)
        return qr(B, mode=mode)

    monkeypatch.setattr(torch.linalg, "qr", recording_qr)
    rng = np.random.default_rng(43)
    x = np.sort(rng.uniform(0, 10, 400))
    y = np.sin(x) + 0.1 * rng.standard_normal(400)
    model = pt.sparse_gp_from_covariance(pt.SquaredExponential(1.0, 1.0) + pt.measurement_only(pt.IndependentNoise(0.1)),
                                         inducing_point_strategy=pt.UniformlySpacedInducingPoints(20))
    xs = np.linspace(0, 10, 33)
    preds = {}
    for dtype in (torch.float32, torch.float64):
        data = pt.RegressionDataset.create(torch.as_tensor(x, dtype=dtype), torch.as_tensor(y, dtype=dtype))
        fit = model.fit(data)
        assert fit.fit.R.dtype == fit.fit.information.dtype == dtype
        preds[dtype] = fit.predict(torch.as_tensor(xs, dtype=dtype)).marginal()
        assert model.log_likelihood(data).dtype == dtype
    assert seen == [torch.float64] * 4
    assert preds[torch.float32].mean.dtype == torch.float32
    _close(preds[torch.float32].mean.double(), preds[torch.float64].mean, rtol=1e-4)
    _close(preds[torch.float32].variance.double(), preds[torch.float64].variance, rtol=1e-4)
