"""Port parity of RANSAC, serial and batched.

The same numpy data and seed go through the JAX package's RANSAC and the
port's, f64 on the CPU.  Both draw the same candidates from
``np.random.default_rng(seed)``, so the audit trails must agree: the
candidates, the inlier and outlier keys and the return codes exactly; the
metric values (small dense conditionings and Cholesky factors) to 1e-9
relative.  The port's batched loop must also give the serial loop's
output.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import models as jmo
from albatross_tpu.evaluation.metrics import NegativeLogLikelihood as JNLL
from albatross_tpu.indexing import KFoldGrouper as JKFold
from albatross_tpu.indexing import LeaveOneOutGrouper as JLOO
from albatross_tpu_torch import models as tmo
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.core import JointDistribution
from albatross_tpu_torch.evaluation import NegativeLogLikelihood as TNLL
from albatross_tpu_torch.evaluation import RootMeanSquareError
from albatross_tpu_torch.indexing import KFoldGrouper as TKFold
from albatross_tpu_torch.indexing import LeaveOneOutGrouper as TLOO

# the package's ``ransac`` name is the loop function, which hides the module
tra = importlib.import_module("albatross_tpu_torch.models.ransac")

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
RTOL = 1e-9


def _data(n=20, n_outliers=3, seed=2012):
    """tests/test_models_misc.py make_outlier_dataset, in both packages."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 10.0, n))
    y = np.sin(x) + 0.05 * rng.standard_normal(n)
    idx = rng.choice(n, size=n_outliers, replace=False)
    y[idx] += rng.choice([-1, 1], n_outliers) * rng.uniform(3.0, 5.0, n_outliers)
    var = np.full(n, 0.0025)
    return (ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y), variance=jnp.asarray(var)),
            pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y), variance=torch.as_tensor(var)),
            set(int(i) for i in idx))


def _models():
    jm = ab.gp_from_covariance(ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.1)))
    tm = pt.gp_from_covariance(pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise()))
    return jm, params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _same_output(got, ref):
    assert got.return_code == ref.return_code
    assert len(got.iterations) == len(ref.iterations)
    for gi, ri in zip(got.iterations + [got.best], ref.iterations + [ref.best]):
        assert gi.candidates == ri.candidates
        assert set(gi.inliers) == set(ri.inliers) and set(gi.outliers) == set(ri.outliers)
        for key in ri.inliers:
            assert gi.inliers[key] == pytest.approx(ri.inliers[key], rel=RTOL)
        for key in ri.outliers:
            assert gi.outliers[key] == pytest.approx(ri.outliers[key], rel=RTOL)
        if np.isnan(ri.consensus_metric_value):
            assert np.isnan(gi.consensus_metric_value)
        else:
            assert gi.consensus_metric_value == pytest.approx(ri.consensus_metric_value, rel=RTOL)


def _strategies():
    return {
        "default": (jmo.DefaultGPRansacStrategy(), tmo.DefaultGPRansacStrategy()),
        "chi2": (jmo.gp_ransac_strategy(JNLL(ab.JointDistribution), jmo.ChiSquaredConsensusMetric(), JLOO(),
                                        is_valid_candidate=jmo.ChiSquaredIsValidCandidateMetric()),
                 tmo.gp_ransac_strategy(TNLL(JointDistribution), tmo.ChiSquaredConsensusMetric(), TLOO(),
                                        is_valid_candidate=tmo.ChiSquaredIsValidCandidateMetric())),
        "entropy-kfold": (jmo.gp_ransac_strategy(JNLL(ab.JointDistribution),
                                                 jmo.DifferentialEntropyConsensusMetric(), JKFold(5)),
                          tmo.gp_ransac_strategy(TNLL(JointDistribution),
                                                 tmo.DifferentialEntropyConsensusMetric(), TKFold(5))),
    }


@pytest.mark.parametrize("which", ["default", "chi2", "entropy-kfold"])
def test_gp_ransac_serial_and_batched_match_jax(which):
    jd, td, outliers = _data()
    jm, tm = _models()
    js, ts = _strategies()[which]
    config = (1.0, 3, 10, 12, 12) if which != "entropy-kfold" else (40.0, 2, 3, 6, 6)
    jout = jm.ransac(js, ab.RansacConfig(*config), use_batched=False).fit(jd).fit.ransac_output
    for use_batched in (False, True):
        tfit = tm.ransac(ts, pt.RansacConfig(*config), use_batched=use_batched).fit(td)
        _same_output(tfit.fit.ransac_output, jout)
    jfit = jm.ransac(js, ab.RansacConfig(*config), use_batched=True).fit(jd)
    _same_output(tfit.fit.ransac_output, jfit.fit.ransac_output)
    xs = np.linspace(0.5, 9.5, 9)
    got, ref = tfit.predict(torch.as_tensor(xs)).marginal(), jfit.predict(jnp.asarray(xs)).marginal()
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(ref.mean), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got.variance.numpy(), np.asarray(ref.variance), rtol=RTOL, atol=1e-12)
    if which == "default":
        assert not set(tfit.fit.ransac_output.best.consensus()) & outliers


def test_batched_path_launches_once_and_reads_back_once(monkeypatch):
    """All candidates' scores come from one batched evaluation."""
    _, td, _ = _data()
    _, tm = _models()
    calls = []
    scores = tra._scores
    monkeypatch.setattr(tra, "_scores", lambda *a: calls.append(1) or scores(*a))
    out = tm.ransac(tmo.DefaultGPRansacStrategy(), pt.RansacConfig(1.0, 3, 10, 12, 12)).fit(td).fit.ransac_output
    assert calls == [1] and tmo.ransac_success(out.return_code) and len(out.iterations) == 12


def test_batched_inlier_metrics_equal_the_serial_callbacks():
    _, td, _ = _data()
    _, tm = _models()
    strategy = tmo.DefaultGPRansacStrategy()
    functions = strategy(tm, td)
    cond = pt.ConditionalGaussian(tm.prior(td.features), td.targets)
    cands = np.asarray([[0, 4, 9], [2, 3, 17]])
    idx_mat = np.arange(20)[:, None]
    batched = tra.batched_inlier_metrics(cond, cands, idx_mat).numpy()
    for k, cand in enumerate(cands):
        fit = functions.fitter(list(cand))
        serial = [float(functions.inlier_metric(g, fit)) for g in range(20)]
        np.testing.assert_allclose(batched[k], serial, rtol=1e-12)


def test_ransac_invalid_arguments_match_jax():
    jd, td, _ = _data()
    jm, tm = _models()
    for use_batched in (False, True):
        jfit = jm.ransac(jmo.DefaultGPRansacStrategy(), ab.RansacConfig(1.0, 50, 60, 5, 5),
                         use_batched=use_batched).fit(jd)
        tfit = tm.ransac(tmo.DefaultGPRansacStrategy(), pt.RansacConfig(1.0, 50, 60, 5, 5),
                         use_batched=use_batched).fit(td)
        assert tfit.fit.ransac_output.return_code == jfit.fit.ransac_output.return_code
        assert tfit.fit.ransac_output.return_code == tmo.RansacReturnCode.INVALID_ARGUMENTS
        with pytest.raises(RuntimeError, match="INVALID_ARGUMENTS"):
            tfit.predict(torch.as_tensor([1.0], dtype=torch.float64)).mean()


def test_ransac_failed_candidates_match_jax():
    """An impossible validity threshold rejects every candidate: the loop
    stops at max_failed_candidates without using an iteration slot."""
    jd, td, _ = _data()
    jm, tm = _models()
    js = jmo.gp_ransac_strategy(None, None, JLOO(), is_valid_candidate=jmo.ChiSquaredIsValidCandidateMetric(-1.0))
    ts = tmo.gp_ransac_strategy(None, None, TLOO(), is_valid_candidate=tmo.ChiSquaredIsValidCandidateMetric(-1.0))
    jout = jm.ransac(js, ab.RansacConfig(1.0, 3, 10, 6, 4), use_batched=False).fit(jd).fit.ransac_output
    assert jout.return_code == jmo.RansacReturnCode.EXCEEDED_MAX_FAILED_CANDIDATES
    for use_batched in (False, True):
        tout = tm.ransac(ts, pt.RansacConfig(1.0, 3, 10, 6, 4), use_batched=use_batched).fit(td).fit.ransac_output
        _same_output(tout, jout)


def test_generic_ransac_strategy_matches_jax():
    jd, td, outliers = _data(n=15, n_outliers=2)
    jm, tm = _models()
    config = (3.0, 3, 8, 4, 4)
    jout = jm.ransac(jmo.DefaultRansacStrategy(), ab.RansacConfig(*config)).fit(jd).fit.ransac_output
    tout = tm.ransac(tmo.DefaultRansacStrategy(), pt.RansacConfig(*config)).fit(td).fit.ransac_output
    _same_output(tout, jout)
    assert tmo.ransac_success(tout.return_code) and not set(tout.best.consensus()) & outliers
    with pytest.raises(ValueError, match="GaussianProcessRansacStrategy"):
        tm.ransac(tmo.DefaultRansacStrategy(), pt.RansacConfig(*config), use_batched=True).fit(td)


def test_unknown_metric_takes_the_serial_loop(monkeypatch):
    """The port batches only the metrics it knows; any other inlier metric
    runs the serial loop, with the JAX package's output."""
    jd, td, _ = _data()
    jm, tm = _models()
    monkeypatch.setattr(tra, "_scores", lambda *a: pytest.fail("the batched path ran"))
    jout = jm.ransac(jmo.gp_ransac_strategy(ab.evaluation.RootMeanSquareError(), None, JLOO()),
                     ab.RansacConfig(0.5, 3, 10, 6, 6), use_batched=False).fit(jd).fit.ransac_output
    tout = tm.ransac(tmo.gp_ransac_strategy(RootMeanSquareError(), None, TLOO()),
                     pt.RansacConfig(0.5, 3, 10, 6, 6)).fit(td).fit.ransac_output
    _same_output(tout, jout)
