"""Port parity of datasets, grouping, the factor's inverse pieces and fast
LOO / LOGO cross-validation.

The same numpy inputs go through the JAX package and the port, f64 on the
CPU.  The inverse pieces and the held-out predictions run the same
algorithms in both (blocked triangular inverse, GEMM-composed products,
batched Cholesky of the stacked blocks), so they agree to f64 rounding
amplified by the condition number: 1e-10 relative to the largest entry.
The fast paths are also held against brute-force dense conditioning, as
the JAX package's tests/test_evaluation.py holds its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import evaluation as jev
from albatross_tpu import indexing as jix
from albatross_tpu.core import dataset as jds
from albatross_tpu.ops import nlml as jnlml
from albatross_tpu.ops.linalg import CholeskyFactor as JCholeskyFactor
from albatross_tpu_torch import evaluation as tev
from albatross_tpu_torch import indexing as tix
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.core import dataset as tds
from albatross_tpu_torch.evaluation import cross_validation_utils as tcvu
from albatross_tpu_torch.ops import nlml as tnlml
from albatross_tpu_torch.ops.linalg import CholeskyFactor as TCholeskyFactor

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
RTOL = 1e-10


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.max(np.abs(b)), 1e-300) if b.size else 1.0
    assert np.max(np.abs(a - b), initial=0.0) <= rtol * scale, np.max(np.abs(a - b)) / scale


def _toy(n, seed=2012, variance=0.01):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    v = np.full(n, variance)
    return (ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jnp.asarray(v)),
            pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=torch.as_tensor(v)))


def _models(jitter=0.0, ls=1.5):
    jm = ab.gp_from_covariance(ab.SquaredExponential(ls, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2)),
                               jitter=jitter)
    tm = pt.gp_from_covariance(pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise()), jitter=jitter)
    return jm, params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _same_dataset(t, j):
    _close(t.features, j.features, 0)
    _close(t.targets.mean, j.targets.mean, 0)
    _close(t.targets.get_variance(), j.targets.get_variance(), 0)
    assert t.metadata == j.metadata


# ---------------------------------------------------------------------------
# datasets and grouping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["subset", "getitem", "metadata", "concatenate", "deduplicate", "transform",
                                "align", "features"])
def test_dataset_operations_match_jax(op):
    jd, td = _toy(12)
    if op == "subset":
        idx = np.asarray([5, 0, 7, 7])
        _same_dataset(td.subset(idx), jd.subset(jnp.asarray(idx)))
    elif op == "getitem":
        _same_dataset(td[3], jd[3])
        _same_dataset(td[torch.arange(2, 6)], jd[jnp.arange(2, 6)])
    elif op == "metadata":
        _same_dataset(td.with_metadata(site="a").with_metadata(run="2"),
                      jd.with_metadata(site="a").with_metadata(run="2"))
    elif op == "concatenate":
        parts_t = [td.subset(np.arange(0, 5)).with_metadata(a="1"), td.subset(np.arange(5, 12))]
        parts_j = [jd.subset(jnp.arange(0, 5)).with_metadata(a="1"), jd.subset(jnp.arange(5, 12))]
        _same_dataset(tds.concatenate_datasets(parts_t), jds.concatenate_datasets(parts_j))
    elif op == "deduplicate":
        idx = np.asarray([0, 1, 2, 1, 3, 0, 4])
        got, ref = tds.deduplicate(td.subset(idx)), jds.deduplicate(jd.subset(jnp.asarray(idx)))
        _same_dataset(got, ref)
        assert got.size == 5
    elif op == "transform":
        A = np.random.default_rng(3).standard_normal((4, 12))
        got, ref = tds.transform_dataset(A, td), jds.transform_dataset(jnp.asarray(A), jd)
        _close(got.targets.mean, ref.targets.mean)
        _close(got.targets.variance, ref.targets.variance)
        _close(got.features.values, ref.features.values, 0)
        _close(got.features.coefficients, ref.features.coefficients, 0)
        assert got.size == 4
    elif op == "align":
        other_t, other_j = td.subset(np.asarray([9, 3, 4, 11])), jd.subset(jnp.asarray([9, 3, 4, 11]))
        got = tds.align_datasets(td, other_t, lambda f: np.round(_np(f), 6))
        ref = jds.align_datasets(jd, other_j, lambda f: np.round(np.asarray(f), 6))
        for g, r in zip(got, ref):
            _same_dataset(g, r)
        empty = tds.align_datasets(td.subset([0]), td.subset([1]), lambda f: _np(f))
        assert empty[0].size == 0 and empty[1].size == 0
    else:  # subset_features / concatenate_features, Measurement-aware
        meas_t, meas_j = pt.Measurement(td.features), ab.Measurement(jd.features)
        got = tds.subset_features(meas_t, [1, 4])
        assert isinstance(got, pt.Measurement)
        _close(got.value, jds.subset_features(meas_j, jnp.asarray([1, 4])).value, 0)
        cat = tds.concatenate_features([meas_t, meas_t])
        assert isinstance(cat, pt.Measurement)
        _close(cat.value, jds.concatenate_features([meas_j, meas_j]).value, 0)


def _ragged(features):
    return (_np(features) > 5.0).astype(int)


@pytest.mark.parametrize("grouper", ["kfold", "loo", "ragged"])
def test_group_by_matches_jax(grouper):
    jd, td = _toy(11)
    tg = {"kfold": tix.KFoldGrouper(3), "loo": tix.LeaveOneOutGrouper(), "ragged": _ragged}[grouper]
    jg = {"kfold": jix.KFoldGrouper(3), "loo": jix.LeaveOneOutGrouper(), "ragged": _ragged}[grouper]
    tgb, jgb = tix.group_by(td, tg), jix.group_by(jd, jg)
    ti, ji = tgb.indexers(), jgb.indexers()
    assert ti.keys() == ji.keys()
    for a, b in zip(ti.values(), ji.values()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64
    assert tgb.counts().get_map() == jgb.counts().get_map()
    _same_dataset(tgb.groups().combine(), jgb.groups().combine())
    _same_dataset(tgb.filter(lambda d: float(d.targets.mean[0]) > 0),
                  jgb.filter(lambda d: float(d.targets.mean[0]) > 0))
    sums_t = tgb.apply(lambda d: float(torch.sum(d.targets.mean)))
    sums_j = jgb.apply(lambda d: float(jnp.sum(d.targets.mean)))
    assert sums_t.get_map() == pytest.approx(sums_j.get_map(), rel=1e-14)
    assert sums_t.min_key() == sums_j.min_key() and sums_t.max_key() == sums_j.max_key()
    paired = tix.group_by(td.features, tg).with_(list(range(11)))
    ref = jix.group_by(jd.features, jg).with_(list(range(11)))
    assert [p[1] for p in paired.values()] == [p[1] for p in ref.values()]


def test_grouped_helpers_match_jax():
    data = {3: 1.5, "b": 2.0, 1: 0.5, "a": 4.0}
    t, j = tix.Grouped(data), jix.Grouped(data)
    assert t.keys() == j.keys() and t.values() == j.values()
    assert t.erase(1).keys() == j.erase(1).keys()
    assert t.apply(lambda k, v: (k, v)).values() == j.apply(lambda k, v: (k, v)).values()
    assert t.filter(lambda v: v > 1).keys() == j.filter(lambda v: v > 1).keys()
    assert (t.sum(), t.mean(), t.min(), t.max(), t.first_group(), t.last_value()) == (
        j.sum(), j.mean(), j.min(), j.max(), j.first_group(), j.last_value())
    np.testing.assert_array_equal(tix.indices_complement([0, 3], 6), jix.indices_complement([0, 3], 6))
    assert tix.unique_values(torch.tensor([3, 1, 3])) == jix.unique_values(jnp.asarray([3, 1, 3]))
    with pytest.raises(ValueError, match="exactly one"):
        tix.unique_value([1, 2])
    combined = tix.Grouped({0: torch.tensor([1.0, 2.0]), 1: torch.tensor(3.0)}).combine()
    torch.testing.assert_close(combined, torch.tensor([1.0, 2.0, 3.0]))


def test_folds_match_jax():
    jd, td = _toy(10)
    for tf, jf in ((tev.leave_one_out_folds(td), jev.leave_one_out_folds(jd)),
                   (tev.k_fold_folds(td, 3), jev.k_fold_folds(jd, 3))):
        assert tf.keys() == jf.keys()
        for a, b in zip(tf.values(), jf.values()):
            np.testing.assert_array_equal(a.test_indices, b.test_indices)
            _same_dataset(a.train_dataset, b.train_dataset)
            _same_dataset(a.test_dataset, b.test_dataset)


# ---------------------------------------------------------------------------
# the factor's inverse pieces and ops/nlml.py
# ---------------------------------------------------------------------------
def _factor(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    return np.linalg.cholesky(M @ M.T / n + np.eye(n))


# 300: one solve; 2304: 256-blocks, batched diagonal solves; 2113: padded
# to 2560 (1280-blocks); 4096: 2048-blocks with GEMM-composed diagonals
@pytest.mark.parametrize("n", [300, 2304, 2113, 4096])
def test_nlml_inverse_ops_match_jax(n):
    L = _factor(n)
    W_ref = jnlml.tri_inverse_full(jnp.asarray(L))
    W = tnlml.tri_inverse_full(torch.as_tensor(L))
    _close(W, W_ref)
    _close(tnlml.blocked_lauum(W), jnlml.blocked_lauum(W_ref))
    _close(tnlml.spd_inverse_from_factor(torch.as_tensor(L)), jnlml.spd_inverse_from_factor(jnp.asarray(L)))


@pytest.mark.parametrize("n", [300, 2304])
def test_factor_inverse_pieces_match_jax(n):
    L = _factor(n)
    tc, jc = TCholeskyFactor(torch.as_tensor(L)), JCholeskyFactor(jnp.asarray(L))
    rng = np.random.default_rng(n + 1)
    v, M = rng.standard_normal(n), rng.standard_normal((n, 3))
    _close(tc.inverse(), jc.inverse())
    _close(tc.inverse_diagonal(), jc.inverse_diagonal())
    groups = [np.asarray([0, 5, 9]), np.arange(n - 4, n), np.asarray([7])]
    for a, b in zip(tc.inverse_blocks(groups), jc.inverse_blocks([jnp.asarray(g) for g in groups])):
        _close(a, b)
    for name in ("sqrt_transpose_solve", "sqrt_product", "matmul", "solve", "sqrt_solve"):
        for rhs in (v, M):
            _close(getattr(tc, name)(torch.as_tensor(rhs)), getattr(jc, name)(jnp.asarray(rhs)))
    assert bool(tc.is_positive_definite()) and bool(jc.is_positive_definite())
    bad = L.copy()
    bad[2, 2] = -1.0
    assert not bool(TCholeskyFactor(torch.as_tensor(bad)).is_positive_definite())


# ---------------------------------------------------------------------------
# held-out predictions: the three paths
# ---------------------------------------------------------------------------
def _dist_parts(d):
    if isinstance(d, (pt.JointDistribution, ab.JointDistribution)):
        return [d.mean, d.covariance]
    if isinstance(d, (pt.MarginalDistribution, ab.MarginalDistribution)):
        return [d.mean, d.variance]
    return [d]


@pytest.mark.parametrize("predict_type", ["marginal", "joint", "mean"])
@pytest.mark.parametrize("grouper", ["loo", "kfold", "ragged"])
@pytest.mark.parametrize("n", [16, 2304])
def test_held_out_predictions_match_jax(n, grouper, predict_type):
    """LOO without a joint takes the vectorized path, groups of one size
    the batched one, the ragged grouper the per-group one; n = 2304 fits
    with the blocked factorization and inverts with the blocked L^-1."""
    jd, td = _toy(n, seed=n)
    jm, tm = _models()
    tg = {"loo": tix.LeaveOneOutGrouper(), "kfold": tix.KFoldGrouper(4), "ragged": _ragged}[grouper]
    jg = {"loo": jix.LeaveOneOutGrouper(), "kfold": jix.KFoldGrouper(4), "ragged": _ragged}[grouper]
    tt = {"marginal": pt.MarginalDistribution, "joint": pt.JointDistribution, "mean": None}[predict_type]
    jt = {"marginal": ab.MarginalDistribution, "joint": ab.JointDistribution, "mean": None}[predict_type]
    got = tm.cross_validated_predictions(td, tix.group_by(td, tg).indexers(), tt)
    ref = jm.cross_validated_predictions(jd, jix.group_by(jd, jg).indexers(), jt)
    assert type(got).__name__ == type(ref).__name__  # the same path
    assert got.keys() == ref.keys()
    for key in ref.keys():
        for a, b in zip(_dist_parts(got[key]), _dist_parts(ref[key])):
            _close(a, b)


def _brute_force_conditional(data, model, test_idx):
    """Dense conditioning on the complement: the fast CV's ground truth."""
    prior = model.prior(data.features)
    K = _np(prior.covariance) + np.diag(_np(data.targets.get_variance()))
    y = _np(data.targets.mean) - _np(prior.mean)
    train = np.setdiff1d(np.arange(K.shape[0]), test_idx)
    Ktt, Kst = K[np.ix_(train, train)], K[np.ix_(test_idx, train)]
    mean = _np(prior.mean)[test_idx] + Kst @ np.linalg.solve(Ktt, y[train])
    cov = K[np.ix_(test_idx, test_idx)] - Kst @ np.linalg.solve(Ktt, Kst.T)
    return mean, cov


@pytest.mark.parametrize("grouper", ["loo", "kfold", "ragged"])
def test_fast_cv_matches_brute_force(grouper):
    _, td = _toy(16)
    _, tm = _models()
    g = {"loo": tix.LeaveOneOutGrouper(), "kfold": tix.KFoldGrouper(4), "ragged": _ragged}[grouper]
    joints = tm.cross_validate().predict(td, g).joints()
    for key, idx in tix.group_by(td, g).indexers().items():
        mean, cov = _brute_force_conditional(td, tm, idx)
        np.testing.assert_allclose(_np(joints[key].mean), mean, rtol=1e-7)
        np.testing.assert_allclose(_np(joints[key].covariance), cov, rtol=1e-6, atol=1e-12)
    if grouper == "loo":  # the latent mean equals the per-fold refit's mean
        means = tm.cross_validate().predict(td, g).means()
        for key, fold in tev.leave_one_out_folds(td).items():
            np.testing.assert_allclose(_np(means[key]), _np(tev.predict_fold(tm, fold).mean()), rtol=1e-7)


def test_conditionals_and_scatter_match_jax():
    jd, td = _toy(12)
    jm, tm = _models()
    loo_t = tev.leave_one_out_conditional(tm.prior(td.features), td.targets)
    loo_j = jev.leave_one_out_conditional(jm.prior(jd.features), jd.targets)
    _close(loo_t.mean, loo_j.mean)
    _close(loo_t.variance, loo_j.variance)
    logo_t = tev.leave_one_group_out_conditional(tm.prior(td.features), td.targets,
                                                 tix.group_by(td, tix.KFoldGrouper(3)).indexers())
    logo_j = jev.leave_one_group_out_conditional(jm.prior(jd.features), jd.targets,
                                                 jix.group_by(jd, jix.KFoldGrouper(3)).indexers())
    for key in logo_j.keys():
        _close(logo_t[key].mean, logo_j[key].mean)
        _close(logo_t[key].variance, logo_j[key].variance)
    for tg, jg in ((tix.KFoldGrouper(3), jix.KFoldGrouper(3)), (_ragged, _ragged)):
        pred_t, pred_j = tm.cross_validate().predict(td, tg), jm.cross_validate().predict(jd, jg)
        _close(pred_t.mean(), pred_j.mean())
        m_t, m_j = pred_t.marginal(), pred_j.marginal()
        _close(m_t.mean, m_j.mean)
        _close(m_t.variance, m_j.variance)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_prediction_metrics_match_jax():
    rng = np.random.default_rng(4)
    mean, var, truth, tvar = rng.standard_normal(6), rng.uniform(0.1, 1, 6), rng.standard_normal(6), \
        rng.uniform(0, 0.1, 6)
    cov = np.cov(rng.standard_normal((6, 20))) + np.eye(6)
    tm_, jm_ = pt.MarginalDistribution(torch.as_tensor(mean), torch.as_tensor(var)), \
        ab.MarginalDistribution(jnp.asarray(mean), jnp.asarray(var))
    tj, jj = pt.JointDistribution(torch.as_tensor(mean), torch.as_tensor(cov)), \
        ab.JointDistribution(jnp.asarray(mean), jnp.asarray(cov))
    tt, jt = pt.MarginalDistribution(torch.as_tensor(truth), torch.as_tensor(tvar)), \
        ab.MarginalDistribution(jnp.asarray(truth), jnp.asarray(tvar))
    cases = [
        (tev.RootMeanSquareError()(tm_, tt), jev.RootMeanSquareError()(jm_, jt)),
        (tev.StandardDeviation()(tm_, tt), jev.StandardDeviation()(jm_, jt)),
        (tev.NegativeLogLikelihood()(tm_, tt), jev.NegativeLogLikelihood()(jm_, jt)),
        (tev.NegativeLogLikelihood(pt.JointDistribution)(tj, tt),
         jev.NegativeLogLikelihood(ab.JointDistribution)(jj, jt)),
        (tev.Crps()(tm_, tt), jev.Crps()(jm_, jt)),
        (tev.crps_normal(0.3, 1.2, -0.5), jev.crps_normal(0.3, 1.2, -0.5)),
        (tev.crps_normal(1.0, 0.0, 3.0), jev.crps_normal(1.0, 0.0, 3.0)),
        (tev.differential_entropy(torch.as_tensor(cov)), jev.differential_entropy(jnp.asarray(cov))),
        (tev.differential_entropy(torch.as_tensor(var)), jev.differential_entropy(jnp.asarray(var))),
    ]
    for got, ref in cases:
        assert float(got) == pytest.approx(float(ref), rel=1e-12)
    assert np.isnan(float(tev.crps_normal(float("nan"), 1.0, 0.0)))
    assert float(tev.StandardDeviation()(tm_.mean[:1], pt.MarginalDistribution(tt.mean[:1]))) == 0.0


def test_metrics_accept_lazy_predictions():
    jd, td = _toy(12)
    jm, tm = _models()
    tp = tm.fit(td.subset(np.arange(8))).predict(td.subset(np.arange(8, 12)).features)
    jp = jm.fit(jd[jnp.arange(8)]).predict(jd[jnp.arange(8, 12)].features)
    truth_t, truth_j = td.subset(np.arange(8, 12)).targets, jd[jnp.arange(8, 12)].targets
    for tmetric, jmetric in ((tev.RootMeanSquareError(), jev.RootMeanSquareError()),
                             (tev.NegativeLogLikelihood(), jev.NegativeLogLikelihood()),
                             (tev.NegativeLogLikelihood(pt.JointDistribution),
                              jev.NegativeLogLikelihood(ab.JointDistribution))):
        assert float(tmetric(tp, truth_t)) == pytest.approx(float(jmetric(jp, truth_j)), rel=1e-10)


@pytest.mark.parametrize("metric", ["rmse", "nll", "nll_joint"])
@pytest.mark.parametrize("grouper", ["loo", "kfold", "ragged"])
def test_cv_scores_match_jax_and_the_fold_loop(metric, grouper):
    """CrossValidation.scores, batched over the groups by torch.func.vmap
    where they have one size, against the JAX package's and against the
    per-fold loop."""
    jd, td = _toy(40, seed=7)
    jm, tm = _models()
    tg = {"loo": tix.LeaveOneOutGrouper(), "kfold": tix.KFoldGrouper(5), "ragged": _ragged}[grouper]
    jg = {"loo": jix.LeaveOneOutGrouper(), "kfold": jix.KFoldGrouper(5), "ragged": _ragged}[grouper]
    tmet = {"rmse": tev.RootMeanSquareError(), "nll": tev.NegativeLogLikelihood(),
            "nll_joint": tev.NegativeLogLikelihood(pt.JointDistribution)}[metric]
    jmet = {"rmse": jev.RootMeanSquareError(), "nll": jev.NegativeLogLikelihood(),
            "nll_joint": jev.NegativeLogLikelihood(ab.JointDistribution)}[metric]
    got = tm.cross_validate().scores(tmet, td, tg)
    _close(got, jm.cross_validate().scores(jmet, jd, jg))
    indexers = tix.group_by(td, tg).indexers()
    preds = tm.cross_validate().predict(td, tg).get(tmet.required_predict_type)
    slow = tcvu.cross_validated_scores(tmet, tev.folds_from_group_indexer(td, indexers), preds)
    _close(got, slow)
    if grouper != "ragged":
        assert isinstance(preds, tcvu.BatchedGrouped)
        assert tcvu.batched_cross_validated_scores(tmet, td, indexers, preds) is not None


@pytest.mark.parametrize("metric,n", [("loo_joint", 15), ("loo_marginal", 15), ("logo", 15), ("loo_rmse", 15),
                                      ("loo_marginal", 2304)])
def test_cv_model_metrics_value_and_gradient_match_jax(metric, n):
    """The LOO and LOGO metrics as tuning objectives: values and gradients
    with respect to the tunable vector (length scale, sigma, noise sigma)
    against jax.value_and_grad of the JAX package's (n = 2304 fits with the
    blocked factorization and inverts with the blocked L^-1; the JAX
    package's gradient there takes ~10-30 s a metric, so one metric)."""
    jd, td = _toy(n, seed=n)
    jm, tm = _models(ls=1.5 if n < 100 else 0.3)
    tmet = {"loo_joint": tev.LeaveOneOutLikelihood(), "loo_marginal": tev.LeaveOneOutLikelihood(
        pt.MarginalDistribution), "logo": tev.LeaveOneGroupOutLikelihood(tix.KFoldGrouper(5)),
        "loo_rmse": tev.LeaveOneOutRMSE()}[metric]
    jmet = {"loo_joint": jev.LeaveOneOutLikelihood(), "loo_marginal": jev.LeaveOneOutLikelihood(
        ab.MarginalDistribution), "logo": jev.LeaveOneGroupOutLikelihood(jix.KFoldGrouper(5)),
        "loo_rmse": jev.LeaveOneOutRMSE()}[metric]
    x0 = jm.get_tunable_parameters().values
    ref_value, ref_grad = jax.value_and_grad(lambda v: jmet(jd, jm.set_tunable_params(v)))(x0)
    xv = tm.get_tunable_parameters().values.clone().requires_grad_(True)
    value = tmet(td, tm.set_tunable_params(xv))
    (grad,) = torch.autograd.grad(value, xv)
    assert float(value.detach()) == pytest.approx(float(ref_value), rel=1e-9)
    np.testing.assert_allclose(_np(grad), np.asarray(ref_grad), rtol=1e-7, atol=1e-9)


def test_gp_prior_matches_jax():
    jd, td = _toy(9)
    jm, tm = _models()
    tp, jp = tm.prior(td.features), jm.prior(jd.features)
    _close(tp.mean, jp.mean, 0)
    _close(tp.covariance, jp.covariance)
