"""Port parity of mixed (tagged) features and linear combinations.

The same numpy inputs go through the JAX package and the port, f64 on the
CPU: TaggedBatch bookkeeping exactly, tagged and linear-combination grams
to 1e-12 relative, and GPs over a tagged batch and over a
``transform_dataset`` dataset (fit, predict, log_likelihood) to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu import kernels as jk
from albatross_tpu.core import dataset as jds
from albatross_tpu_torch import kernels as tk
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.core import dataset as tds
from albatross_tpu_torch.kernels.variants import concatenate_mixed_datasets

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
RTOL = 1e-12
POS, BIAS = 0, 1


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.max(np.abs(b)), 1e-300)
    assert np.max(np.abs(a - b)) <= rtol * scale, np.max(np.abs(a - b)) / scale


def _moved(jm, tm):
    return params_from_numpy(tm, {k: np.asarray(p.value) for k, p in jm.get_params().items()})


def _tagged(n_pos=6, n_bias=3, seed=2012, dtype=np.float64):
    """An interleaved batch of positions and bias ids (tests/test_variants.py
    make_tagged), in both packages."""
    rng = np.random.default_rng(seed)
    tags = np.zeros(n_pos + n_bias, dtype=int)
    tags[rng.choice(n_pos + n_bias, n_bias, replace=False)] = BIAS
    positions = np.sort(rng.uniform(0, 10, n_pos)).astype(dtype)
    bias_ids = np.arange(n_bias, dtype=dtype)
    jb = jk.TaggedBatch.create(tags, {POS: jnp.asarray(positions), BIAS: jnp.asarray(bias_ids)})
    tb = tk.TaggedBatch.create(tags, {POS: torch.as_tensor(positions), BIAS: torch.as_tensor(bias_ids)})
    return jb, tb, tags


def _mixed_kernels():
    """tests/test_variants.py mixed_kernel, with measurement noise."""
    jkern = (jk.for_tag(jk.SquaredExponential(2.0, 1.5), POS) + jk.for_tag(jk.IndependentNoise(0.7), BIAS)
             + jk.Constant(0.3) + jk.measurement_only(jk.IndependentNoise(0.1)))
    tkern = (tk.for_tag(tk.SquaredExponential(), POS) + tk.for_tag(tk.IndependentNoise(), BIAS)
             + tk.Constant() + tk.measurement_only(tk.IndependentNoise()))
    return jkern, _moved(jkern, tkern)


def _same_batch(tb, jb):
    assert tb.tags == jb.tags and tb.order == jb.order and tb.counts() == jb.counts()
    for tf, jf in zip(tb.features, jb.features):
        _close(tf, jf, rtol=0)


def test_tagged_batch_create_subset_concatenate_match_jax():
    jb, tb, tags = _tagged(8, 5)
    _same_batch(tb, jb)
    assert tb.size == jb.size == 13
    for idx in ([0, 3, 7, 12, 1], [2, 2, 9], [5]):
        _same_batch(tds.subset_features(tb, np.asarray(idx)), jds.subset_features(jb, jnp.asarray(idx)))
    jb2, tb2, _ = _tagged(3, 2, seed=5)
    _same_batch(tds.concatenate_features([tb, tb2]), jds.concatenate_features([jb, jb2]))
    # a batch that lacks a tag joins one that has it
    only_bias = np.zeros(2, dtype=int) + BIAS
    _same_batch(tk.TaggedBatch.concatenate([tk.TaggedBatch.create(only_bias, {BIAS: torch.ones(2, dtype=torch.float64)}),
                                            tb2]),
                jk.TaggedBatch.concatenate([jk.TaggedBatch.create(only_bias, {BIAS: jnp.ones(2)}), jb2]))
    assert tds.feature_count(tk.as_measurement(tb)) == 13
    with pytest.raises(ValueError, match="cover every tag"):
        tk.TaggedBatch.create(tags, {POS: torch.zeros(8)})


def test_tagged_gram_cross_and_diag_match_jax():
    jb, tb, tags = _tagged()
    jkern, tkern = _mixed_kernels()
    _close(tkern(tb), jkern(jb))
    _close(tkern(tk.as_measurement(tb)), jkern(jk.as_measurement(jb)))
    _close(tkern.diag(tb), jkern.diag(jb))
    _close(tkern.diag(tk.as_measurement(tb)), jkern.diag(jk.as_measurement(jb)))
    xs = np.linspace(0, 10, 4)
    _close(tkern.matrix_or_none(tb, torch.as_tensor(xs)), jkern.matrix_or_none(jb, jnp.asarray(xs)))
    _close(tkern.matrix_or_none(torch.as_tensor(xs), tb), jkern.matrix_or_none(jnp.asarray(xs), jb))
    jb2, tb2, _ = _tagged(4, 2, seed=9)
    _close(tkern.matrix_or_none(tb, tb2), jkern.matrix_or_none(jb, jb2))
    # the block structure (tests/test_variants.py): cross blocks hold only the constant
    K = _np(tkern(tb))
    pos, bias = np.nonzero(tags == POS)[0], np.nonzero(tags == BIAS)[0]
    np.testing.assert_allclose(K[np.ix_(pos, bias)], 0.09, rtol=1e-12)


def test_zero_blocks_take_the_blocks_dtype_and_device():
    _, tb, _ = _tagged(dtype=np.float32)
    tkern = tk.for_tag(tk.SquaredExponential(2.0, 1.5), POS) + tk.for_tag(tk.IndependentNoise(0.7), BIAS)
    K = tkern(tb)
    assert K.dtype == torch.float32 and tkern.diag(tb).dtype == torch.float32
    pos_only = tk.for_tag(tk.SquaredExponential(2.0, 1.5), POS)
    assert pos_only.matrix_or_none(tb, tb).dtype == torch.float32


def _gp_pair(jkern, tkern, jitter=0.0):
    jm = ab.gp_from_covariance(jkern, jitter=jitter)
    return jm, _moved(jm, pt.gp_from_covariance(tkern, jitter=jitter))


def test_gp_over_tagged_batch_matches_jax():
    jb, tb, tags = _tagged(40, 9)
    n = len(tags)
    y = np.random.default_rng(4).standard_normal(n)
    jm, tm = _gp_pair(*_mixed_kernels())
    jd = ab.RegressionDataset.create(jb, jnp.asarray(y), variance=jnp.full((n,), 0.01))
    td = pt.RegressionDataset.create(tb, torch.as_tensor(y), variance=torch.full((n,), 0.01, dtype=torch.float64))
    assert td.size == n and td.targets.mean.dtype == torch.float64
    assert float(tm.log_likelihood(td)) == pytest.approx(float(jm.log_likelihood(jd)), rel=1e-10)
    jfit, tfit = jm.fit(jd), tm.fit(td)
    xs = np.linspace(0, 10, 5)
    for jp, tp in ((jfit.predict(jnp.asarray(xs)), tfit.predict(torch.as_tensor(xs))),
                   (jfit.predict(jb), tfit.predict(tb))):
        _close(tp.mean(), jp.mean(), rtol=1e-10)
        _close(tp.marginal().variance, jp.marginal().variance, rtol=1e-10)
        _close(tp.joint().covariance, jp.joint().covariance, rtol=1e-10)
    # not the fused pattern, and no error on the way there
    assert tm._training_cov_fused_pieces(tk.as_measurement(tb)) is None
    assert tm._training_covariance(tk.as_measurement(tb), None)[1] is False
    plain = tk.as_measurement(torch.linspace(0, 1, 5, dtype=torch.float64))  # a ForTag term over plain features
    assert tm._training_cov_fused_pieces(plain) is None
    assert tm._training_covariance(plain, None)[1] is False


def test_concatenate_mixed_datasets_matches_jax():
    rng = np.random.default_rng(8)
    x, ids = np.sort(rng.uniform(0, 10, 5)), np.arange(3.0)
    y1, y2 = rng.standard_normal(5), rng.standard_normal(3)
    jd = jk.variants.concatenate_mixed_datasets([
        ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y1)),
        ab.RegressionDataset.create(jnp.asarray(ids), jnp.asarray(y2))], tags=[POS, BIAS])
    td = concatenate_mixed_datasets([
        pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y1)),
        pt.RegressionDataset.create(torch.as_tensor(ids), torch.as_tensor(y2))], tags=[POS, BIAS])
    _same_batch(td.features, jd.features)
    _close(td.targets.mean, jd.targets.mean, rtol=0)
    with pytest.raises(ValueError, match="distinct"):
        concatenate_mixed_datasets([td, td], tags=[0, 0])


def _combinations(seed=6):
    rng = np.random.default_rng(seed)
    a, b = rng.uniform(0, 5, 6), rng.uniform(0, 5, 6)
    three = rng.uniform(0, 5, 3)
    c = np.asarray([0.2, -1.0, 0.7])
    t = torch.as_tensor
    return [
        ("difference_of", jk.difference_of(jnp.asarray(a), jnp.asarray(b)), tk.difference_of(t(a), t(b))),
        ("sum_of", jk.sum_of(jnp.asarray(three)), tk.sum_of(t(three))),
        ("mean_of", jk.mean_of(jnp.asarray(three)), tk.mean_of(t(three))),
        ("to_linear_combination", jk.to_linear_combination(jnp.asarray(three), jnp.asarray(c)),
         tk.to_linear_combination(t(three), t(c))),
    ]


@pytest.mark.parametrize("which", ["difference_of", "sum_of", "mean_of", "to_linear_combination"])
def test_linear_combination_grams_match_jax(which):
    jl, tl = next((j, t) for name, j, t in _combinations() if name == which)
    _close(tl.coefficients, jl.coefficients, rtol=0)
    assert tk.to_linear_combination(tl) is tl
    jkern = jk.SquaredExponential(2.0, 1.5) + jk.Matern32(1.0, 0.5) * jk.Constant(0.9) + jk.IndependentNoise(0.2)
    tkern = _moved(jkern, tk.SquaredExponential() + tk.Matern32() * tk.Constant() + tk.IndependentNoise())
    xs = np.linspace(0, 5, 7)
    _close(tkern(tl), jkern(jl))
    _close(tkern.diag(tl), jkern.diag(jl))
    _close(tkern.matrix_or_none(tl, torch.as_tensor(xs)), jkern.matrix_or_none(jl, jnp.asarray(xs)))
    _close(tkern.matrix_or_none(torch.as_tensor(xs), tl), jkern.matrix_or_none(jnp.asarray(xs), jl))
    with pytest.raises(ValueError, match="re-weight"):
        tk.to_linear_combination(tl, torch.ones(2))


def test_gp_over_transformed_dataset_matches_jax():
    rng = np.random.default_rng(12)
    n, m = 30, 12
    x = np.sort(rng.uniform(0, 10, n))
    y = np.sin(x) + 0.1 * rng.standard_normal(n)
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    jd = jds.transform_dataset(jnp.asarray(A), ab.RegressionDataset.create(
        jnp.asarray(x), jnp.asarray(y), variance=jnp.full((n,), 0.01)))
    td = tds.transform_dataset(torch.as_tensor(A), pt.RegressionDataset.create(
        torch.as_tensor(x), torch.as_tensor(y), variance=torch.full((n,), 0.01, dtype=torch.float64)))
    jm, tm = _gp_pair(jk.SquaredExponential(2.0, 1.0) + jk.measurement_only(jk.IndependentNoise(0.1)),
                      tk.SquaredExponential() + tk.measurement_only(tk.IndependentNoise()), jitter=1e-8)
    assert float(tm.log_likelihood(td)) == pytest.approx(float(jm.log_likelihood(jd)), rel=1e-10)
    xs = np.linspace(0, 10, 9)
    jp, tp = jm.fit(jd).predict(jnp.asarray(xs)), tm.fit(td).predict(torch.as_tensor(xs))
    _close(tp.mean(), jp.mean(), rtol=1e-10)
    _close(tp.marginal().variance, jp.marginal().variance, rtol=1e-10)
    diffs = (tk.difference_of(torch.as_tensor(xs[:-1]), torch.as_tensor(xs[1:])),
             jk.difference_of(jnp.asarray(xs[:-1]), jnp.asarray(xs[1:])))
    _close(tm.fit(td).predict(diffs[0]).marginal().variance, jm.fit(jd).predict(diffs[1]).marginal().variance,
           rtol=1e-10)
    assert tm._training_cov_fused_pieces(tk.as_measurement(td.features)) is None
    assert tm._training_covariance(tk.as_measurement(td.features), None)[1] is False


def test_linear_combination_against_a_tagged_batch():
    """The JAX package raises a TypeError for a TaggedBatch against a linear
    combination; the port integrates the combination around the tagged
    gram.  Held against the JAX package's tagged gram over the flattened
    features, contracted by hand, and a GP's prediction of differences
    against its joint prediction at the flattened points."""
    jb, tb, tags = _tagged(12, 4)
    jkern, tkern = _mixed_kernels()
    rng = np.random.default_rng(21)
    a, b = rng.uniform(0, 10, 5), rng.uniform(0, 10, 5)
    lc = tk.difference_of(torch.as_tensor(a), torch.as_tensor(b))
    flat = np.stack([a, b], axis=1).reshape(-1)
    G = np.asarray(jkern.matrix_or_none(jb, jnp.asarray(flat))).reshape(len(tags), 5, 2)
    ref = G[:, :, 0] - G[:, :, 1]
    _close(tkern.matrix_or_none(tb, lc), ref)
    _close(tkern.matrix_or_none(lc, tb), ref.T)
    with pytest.raises(TypeError):
        jkern.matrix_or_none(jb, jk.difference_of(jnp.asarray(a), jnp.asarray(b)))

    y = rng.standard_normal(len(tags))
    _, tm = _gp_pair(*_mixed_kernels())
    fit = tm.fit(pt.RegressionDataset.create(tb, torch.as_tensor(y), variance=torch.full((len(tags),), 0.01,
                                                                                        dtype=torch.float64)))
    pred = fit.predict(lc).marginal()
    joint = fit.predict(torch.as_tensor(flat)).joint()
    C = torch.zeros((5, 10), dtype=torch.float64)
    C[torch.arange(5), 2 * torch.arange(5)] = 1.0
    C[torch.arange(5), 2 * torch.arange(5) + 1] = -1.0
    _close(pred.mean, C @ joint.mean, rtol=1e-10)
    _close(pred.variance, torch.diagonal(C @ joint.covariance @ C.T), rtol=1e-10)
