"""Port parity: the ensemble sampler, its walker-batched log-prob and the
batched kernel forms, against the JAX package.

Torch's generator gives other numbers than JAX's keys, so the step tests
recompute the draws from the JAX package's key schedule (the splits of
``albatross_tpu/samplers/ensemble.py``) and feed them to the port's
deterministic update: given the same draws, a step equals JAX's to 1e-12
(f64; the only differences are the last bits of log z and of the
log-probs).  The walker-batched log-prob is held against the port's
per-walker ``log_likelihood`` and ``jax.vmap`` of the JAX package's to
1e-10 relative at f64: the same factorization route, rounded differently
(O(n^3) f64 work over K with kappa ~1e3).  The chain's statistics are
checked against their truths with Kolmogorov-Smirnov tests.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import albatross_tpu as ab
import albatross_tpu_torch as pt
from albatross_tpu.ops.pallas_chol import pallas_panel_cholinv
from albatross_tpu.ops.pallas_gram import pallas_radial_gram
from albatross_tpu.samplers import CsvWritingCallback as JaxCsvWritingCallback
from albatross_tpu.samplers import ensemble as jax_ensemble
from albatross_tpu_torch import _build, config
from albatross_tpu_torch.convert import params_from_numpy
from albatross_tpu_torch.models.gp import GaussianProcess
from albatross_tpu_torch.ops import batched_nlml
from albatross_tpu_torch.ops.batched_nlml import batched_nlml_terms, bytes_per_walker, walkers_per_batch
from albatross_tpu_torch.ops.panel_cholinv import panel_cholinv_batched, plain_panel_cholinv
from albatross_tpu_torch.ops.radial_gram import plain_radial_gram_diag_batched, radial_gram, radial_gram_diag_batched
from albatross_tpu_torch.samplers import (
    CsvWritingCallback,
    EnsembleChain,
    MaximumLikelihoodTrackingCallback,
    NullCallback,
    SamplerState,
    ensemble_sampler,
    ensemble_sampler_from_model,
    ensure_finite_initial_state,
    initial_params_from_jitter,
    stretch_move_step,
)
from albatross_tpu_torch.samplers.ensemble import HalfStepDraws, RepairDraws, model_log_prob_fn

torch.set_num_threads(2)
# PyTorch's CPU f32 exp can return ~1e-4-wrong values on its first
# multi-threaded call; one warm-up call takes that call out of the tests.
torch.exp(torch.zeros(1 << 16))
STEP_TOL = 1e-12
LL_RTOL = 1e-10


def _box_log_prob_jax(x):
    """-|x|^2 / 2 inside |x_0| < 1.5, -inf outside: a target with
    non-finite log-probs."""
    lp = -0.5 * jnp.sum(x * x, axis=-1)
    return jnp.where(jnp.abs(x[:, 0]) < 1.5, lp, -jnp.inf)


def _box_log_prob_torch(x):
    lp = -0.5 * torch.sum(x * x, dim=-1)
    return torch.where(torch.abs(x[:, 0]) < 1.5, lp, torch.full_like(lp, -torch.inf))


def _gaussian_jax(x):
    return -0.5 * jnp.sum(x * x, axis=-1)


def _gaussian_torch(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def _jax_half_draws(key, others_lp, n_move):
    """The draws ``_half_step`` makes from ``key``."""
    k_choice, k_z, k_accept = jax.random.split(key, 3)
    logits = jnp.where(jnp.isfinite(others_lp), 0.0, -1e30)
    j = jax.random.categorical(k_choice, logits, shape=(n_move,))
    p = jax.random.uniform(k_z, (n_move,))
    u = jax.random.uniform(k_accept, (n_move,))
    return HalfStepDraws(*(torch.as_tensor(np.array(a)) for a in (j, p, u)))


def _jax_step_draws(key, state, new_state):
    """Both halves' draws of JAX's ``stretch_move_step(key, state)``; the
    second half's partner logits are the first half's updated log-probs."""
    n = state.params.shape[0]
    half = n // 2
    k1, k2 = jax.random.split(key)
    da = _jax_half_draws(k1, state.log_prob[half:], half)
    db = _jax_half_draws(k2, new_state.log_prob[:half], n - half)
    return da, db


def _as_torch_state(state):
    return SamplerState(*(torch.as_tensor(np.array(a)) for a in state))


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    finite = np.isfinite(ref)
    assert np.max(np.abs(got[finite] - ref[finite]), initial=0.0) <= tol * max(np.max(np.abs(ref[finite]), initial=0.0), 1.0)


@pytest.mark.parametrize("n_walkers, target", [(8, "gaussian"), (7, "gaussian"), (9, "box")])
def test_stretch_move_step_matches_jax(n_walkers, target):
    """Five chained steps, each fed the JAX package's draws; an odd W gives
    halves of n // 2 and the rest; the box target has walkers at -inf."""
    jfn, tfn = {"gaussian": (_gaussian_jax, _gaussian_torch), "box": (_box_log_prob_jax, _box_log_prob_torch)}[target]
    rng = np.random.default_rng(n_walkers)
    params = rng.standard_normal((n_walkers, 3))
    if target == "box":
        params[1, 0] = 3.0  # outside the box: log-prob -inf
    jstate = jax_ensemble.SamplerState(jnp.asarray(params), jfn(jnp.asarray(params)),
                                       jnp.ones(n_walkers, dtype=bool))
    tstate = _as_torch_state(jstate)
    key = jax.random.PRNGKey(n_walkers)
    accepted_any = False
    for _ in range(5):
        key, k = jax.random.split(key)
        jnext = jax_ensemble.stretch_move_step(k, jstate, jfn, 2.0)
        tnext = stretch_move_step(None, tstate, tfn, 2.0, draws=_jax_step_draws(k, jstate, jnext))
        _close(tnext.params, jnext.params, STEP_TOL)
        _close(tnext.log_prob, jnext.log_prob, STEP_TOL)
        np.testing.assert_array_equal(tnext.accepted.numpy(), np.asarray(jnext.accepted))
        accepted_any |= bool(np.any(np.asarray(jnext.accepted)))
        jstate, tstate = jnext, tnext
    assert accepted_any


def _gp_pair(n, kind="bench", seed=0):
    if kind == "bench":
        jk = ab.SquaredExponential(0.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.3, assume_unique=True))
        tk = pt.SquaredExponential() + pt.measurement_only(pt.IndependentNoise(assume_unique=True))
    else:  # not the fused pattern: by-value noise (an equality mask), Matern 5/2
        jk = ab.Matern52(2.0, 1.3) + ab.IndependentNoise(0.2)
        tk = pt.Matern52() + pt.IndependentNoise()
    jm = ab.gp_from_covariance(jk, jitter=1e-4)
    tm = params_from_numpy(pt.gp_from_covariance(tk, jitter=1e-4),
                           {k: np.asarray(p.value) for k, p in jm.get_params().items()})
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 100 if n > 100 else 10, n))
    y = np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)
    jd = ab.RegressionDataset.create(jnp.asarray(x), jnp.asarray(y))
    td = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y))
    return jm, tm, jd, td


def _jax_log_prob_fn(model, dataset):
    params0 = model.get_params()

    def single(x):
        return model.set_params(ab.core.set_tunable_params(params0, x)).log_likelihood(dataset)

    return jax.jit(jax.vmap(single))


def test_stretch_move_step_gp_log_prob_matches_jax():
    """The GP posterior of the bench model over n = 25 points, W = 7: the
    port's walker-batched log-prob inside each half-step."""
    jm, tm, jd, td = _gp_pair(25)
    jfn, tfn = _jax_log_prob_fn(jm, jd), model_log_prob_fn(tm, td)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    params = x0[None, :] + 0.1 * np.random.default_rng(3).standard_normal((7, x0.shape[0]))
    jstate = jax_ensemble.SamplerState(jnp.asarray(params), jfn(jnp.asarray(params)), jnp.ones(7, dtype=bool))
    tstate = _as_torch_state(jstate)
    key = jax.random.PRNGKey(4)
    for _ in range(3):
        key, k = jax.random.split(key)
        jnext = jax_ensemble.stretch_move_step(k, jstate, jfn, 2.0)
        tnext = stretch_move_step(None, tstate, tfn, 2.0, draws=_jax_step_draws(k, jstate, jnext))
        _close(tnext.params, jnext.params, STEP_TOL)
        _close(tnext.log_prob, jnext.log_prob, 1e-11)  # the GP log-prob's own f64 parity
        np.testing.assert_array_equal(tnext.accepted.numpy(), np.asarray(jnext.accepted))
        jstate, tstate = jnext, tnext


def _jax_repair_draws(key, params, log_prob_fn, max_tries=50):
    """The draws JAX's ``ensure_finite_initial_state`` makes, try by try,
    following its loop."""
    draws = []
    lp = log_prob_fn(params)
    for _ in range(max_tries):
        finite = jnp.isfinite(lp)
        if bool(jnp.all(finite)):
            break
        key, k_pick, k_alpha = jax.random.split(key, 3)
        logits = jnp.where(finite, 0.0, -1e30)
        donors = jax.random.categorical(k_pick, logits, shape=(params.shape[0],))
        alpha = jax.random.uniform(k_alpha, (params.shape[0], 1), minval=0.2, maxval=0.8)
        draws.append(RepairDraws(torch.as_tensor(np.array(donors)), torch.as_tensor(np.array(alpha))))
        params = jnp.where(finite[:, None], params, params[donors] + alpha * (params - params[donors]))
        lp = log_prob_fn(params)
    return draws


def test_ensure_finite_initial_state_matches_jax():
    rng = np.random.default_rng(5)
    params = rng.standard_normal((9, 2))
    params[[1, 4, 6], 0] = [4.0, -6.0, 9.0]  # outside the box
    key = jax.random.PRNGKey(12)
    jp, jlp = jax_ensemble.ensure_finite_initial_state(key, jnp.asarray(params), _box_log_prob_jax)
    draws = _jax_repair_draws(key, jnp.asarray(params), _box_log_prob_jax)
    assert len(draws) >= 2  # more than one try was needed
    evaluated = []

    def counting(x):
        evaluated.append(x.shape[0])
        return _box_log_prob_torch(x)

    tp, tlp = ensure_finite_initial_state(None, torch.as_tensor(params), counting, draws=draws)
    _close(tp, jp, STEP_TOL)
    _close(tlp, jlp, STEP_TOL)
    assert np.all(np.isfinite(tlp.numpy()))
    assert evaluated[0] == 9 and all(k < 9 for k in evaluated[1:])  # only the repaired walkers again


@pytest.mark.parametrize("n, kind", [(25, "bench"), (25, "generic"), (2304, "bench"), (2113, "generic")])
def test_batched_log_prob_matches_per_walker_and_jax_vmap(n, kind):
    """W = 4 walkers: the fused route (one batched gram) for the bench
    kernel, the stacked DSL covariances for the Matern + by-value noise;
    n = 2304 runs several panels of the blocked loop, 2113 pads."""
    jm, tm, jd, td = _gp_pair(n, kind)
    x0 = np.asarray(jm.get_tunable_parameters().values)
    walkers = x0[None, :] + 0.1 * np.random.default_rng(n).standard_normal((4, x0.shape[0]))
    _build.reset_launch_counts()
    got = model_log_prob_fn(tm, td)(torch.as_tensor(walkers))
    assert got.dtype == torch.float64 and got.shape == (4,)
    assert all(v == 0 for v in _build.LAUNCHES.values())  # CPU tensors: plain versions only
    per_walker = torch.stack([tm.set_tunable_params(torch.as_tensor(w)).log_likelihood(td) for w in walkers])
    ref = np.asarray(_jax_log_prob_fn(jm, jd)(jnp.asarray(walkers)))
    np.testing.assert_allclose(got.numpy(), per_walker.numpy(), rtol=LL_RTOL)
    np.testing.assert_allclose(got.numpy(), ref, rtol=LL_RTOL)


@pytest.mark.parametrize("n, kind", [(25, "bench"), (25, "generic"), (3584, "bench")])
def test_batched_log_likelihood_in_memory_batches(monkeypatch, n, kind):
    """Split into batches of 2, as the card's memory splits a large
    ensemble, the walkers' log-probs equal one batch's and the per-walker
    log_likelihood; at n = 3584 the CPU block size 1792 divides n, so the
    blocked loop factors views of the stack in place."""
    from albatross_tpu_torch.models import gp as tgp

    _, tm, _, td = _gp_pair(n, kind)
    x0 = tm.get_tunable_parameters().values
    w = 5 if n < 100 else 3
    models = [tm.set_tunable_params(x0 + 0.1 * torch.as_tensor(r))
              for r in np.random.default_rng(n).standard_normal((w, x0.shape[0]))]
    whole = GaussianProcess.batched_log_likelihood(models, td)
    monkeypatch.setattr(tgp, "walkers_per_batch", lambda w, n, itemsize, device: 2)
    split = GaussianProcess.batched_log_likelihood(models, td)
    per_walker = torch.stack([m.log_likelihood(td) for m in models])
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-12)
    np.testing.assert_allclose(split.numpy(), per_walker.numpy(), rtol=LL_RTOL)


def test_walkers_per_batch_bounds_the_stack_by_memory():
    """The card's batch holds what MEMORY_SHARE of its available memory
    takes: at n = 28672 (f32, 3.5 GB a walker) 80 GB hold 20 of 32
    walkers, at n = 8192 all 32; below one walker it raises, naming W and
    n.  On the CPU every walker goes in one batch."""
    per = bytes_per_walker(28672, 4, torch.device("cuda"))
    assert per == (28672 ** 2 + 2 * 28672 * 1024 + 4 * 1024 ** 2) * 4
    assert walkers_per_batch(32, 28672, 4, "cuda", available=80e9) == int(batched_nlml.MEMORY_SHARE * 80e9) // per
    assert walkers_per_batch(32, 28672, 4, "cuda", available=80e9) == 20
    assert walkers_per_batch(32, 8192, 4, "cuda", available=80e9) == 32
    assert walkers_per_batch(32, 1024, 4, "cpu") == 32
    # a padded n also holds the panels' copies: 3000 pads to 3072
    assert bytes_per_walker(3000, 8, torch.device("cuda")) == (3000 ** 2 + 3072 * 4096 // 2 + 2 * 3072 * 1024
                                                               + 4 * 1024 ** 2) * 8
    assert bytes_per_walker(2048, 4, torch.device("cuda")) == 4 * 2048 ** 2 * 4
    with pytest.raises(MemoryError, match="32 walkers at n = 28672"):
        walkers_per_batch(32, 28672, 4, "cuda", available=1e9)


def test_batched_nlml_isolates_a_non_pd_walker():
    """One indefinite covariance in the stack makes that walker's terms
    NaN and leaves the others equal to their unbatched values, on both
    routes (n <= 2048 and the blocked loop)."""
    rng = np.random.default_rng(1)
    for n in (40, 2304):
        A = rng.standard_normal((3, n, n))
        K = torch.as_tensor(A @ np.swapaxes(A, 1, 2) + n * np.eye(n))
        K[1, 7, 7] = -1e3
        rhs = torch.as_tensor(rng.standard_normal((3, n)))
        log_det, white = batched_nlml_terms(K.clone(), rhs)
        assert torch.isnan(log_det[1]) or torch.isnan(white[1]).any()
        for w in (0, 2):
            ld, wh = pt.ops.linalg.CholeskyFactor.nlml_terms(K[w], rhs[w], assume_symmetric=True)
            assert float(log_det[w]) == pytest.approx(float(ld), rel=1e-12)
            np.testing.assert_allclose(white[w].numpy(), wh.numpy(), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("profile, d", [("squared_exponential", 1), ("matern_32", 3)])
def test_batched_gram_matches_jax_vmap_of_pallas(profile, d):
    """The batched gram's plain version against ``jax.vmap`` of the Pallas
    diagonal kernel (interpret mode) over the walkers' scalars and
    diagonals, at f64."""
    rng = np.random.default_rng(d)
    x = rng.uniform(0, 5, (70, d))
    ls, sg = rng.uniform(0.5, 2.0, 3), rng.uniform(0.5, 2.0, 3)
    diag = rng.uniform(0.01, 0.1, (3, 70))
    ref = jax.vmap(lambda l, s, dg: pallas_radial_gram(jnp.asarray(x), jnp.asarray(x), l, s, profile,
                                                       interpret=True, diag_add=dg))(
        jnp.asarray(ls), jnp.asarray(sg), jnp.asarray(diag))
    got = radial_gram_diag_batched(torch.as_tensor(x), torch.as_tensor(ls), torch.as_tensor(sg),
                                   torch.as_tensor(diag), profile)
    assert got.shape == (3, 70, 70)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-14)
    one = radial_gram(torch.as_tensor(x), torch.as_tensor(x), float(ls[1]), float(sg[1]), profile,
                      diag_add=torch.as_tensor(diag[1]))
    assert torch.equal(got[1], one)


@pytest.mark.parametrize("b", [128, 256])
def test_batched_panel_matches_jax_vmap_of_pallas(b):
    """The batched panel's plain version against ``jax.vmap`` of the Pallas
    panel kernel (interpret mode), f32, at the JAX test's bounds (1e-5 on
    U, 1e-4 on Wu relative to the largest entry)."""
    rng = np.random.default_rng(b)
    A = rng.standard_normal((2, b, b))
    K = (A @ np.swapaxes(A, 1, 2) + b * np.eye(b)).astype(np.float32)
    U_ref, Wu_ref = (np.asarray(t) for t in jax.vmap(lambda a: pallas_panel_cholinv(a, interpret=True))(
        jnp.asarray(K)))
    U, Wu = panel_cholinv_batched(torch.as_tensor(K))
    assert U.dtype == torch.float32 and U.shape == (2, b, b)
    for w in range(2):
        assert np.max(np.abs(U[w].numpy() - U_ref[w])) <= 1e-5 * np.max(np.abs(U_ref[w]))
        assert np.max(np.abs(Wu[w].numpy() - Wu_ref[w])) <= 1e-4 * np.max(np.abs(Wu_ref[w]))
        np.testing.assert_array_equal(np.tril(U[w].numpy(), -1), 0.0)


def test_batched_kernel_forms_guard_their_inputs():
    with pytest.raises(ValueError, match="b % 128"):
        panel_cholinv_batched(torch.eye(100).expand(2, 100, 100))
    with pytest.raises(ValueError, match="stack"):
        panel_cholinv_batched(torch.eye(128))
    with pytest.raises(ValueError, match="profile"):
        radial_gram_diag_batched(torch.zeros(4), torch.ones(1), torch.ones(1), torch.zeros((1, 4)), "cubic")
    U, Wu = plain_panel_cholinv(torch.eye(128, dtype=torch.float64).expand(3, 128, 128))
    assert torch.equal(U, Wu)
    K = plain_radial_gram_diag_batched(torch.zeros(3, dtype=torch.float64), torch.ones(2, dtype=torch.float64),
                                       torch.full((2,), 2.0, dtype=torch.float64),
                                       torch.zeros((2, 3), dtype=torch.float64), "exponential")
    assert torch.equal(K, torch.full((2, 3, 3), 4.0, dtype=torch.float64))


def test_chain_samples_a_gaussian_target():
    """A 2-D standard normal target, 32 walkers, 400 iterations: each
    coordinate's samples (every 10th iteration after 100 of burn-in) pass
    a KS test against N(0, 1); the acceptance rate lies inside (0, 1)."""
    rng = np.random.default_rng(0)
    chain = ensemble_sampler(_gaussian_torch, torch.as_tensor(rng.standard_normal((32, 2))), 400, key=7)
    assert chain.params.shape == (401, 32, 2) and chain.log_prob.shape == (401, 32)
    assert 0.3 < chain.acceptance_rate() < 0.9
    samples = chain.params[100::10].reshape(-1, 2)
    for k in range(2):
        assert stats.kstest(samples[:, k], "norm").pvalue > 1e-3


def test_stretch_draws_follow_the_z_law():
    """z = ((a - 1) p + 1)^2 / a has density proportional to 1 / sqrt(z) on
    [1 / a, a]: CDF (sqrt(z a) - 1) / (a - 1)."""
    from albatross_tpu_torch.samplers.ensemble import draw_half_step

    g = torch.Generator().manual_seed(3)
    p = draw_half_step(g, 20000, torch.zeros(4, dtype=torch.float64)).p.numpy()
    a = 2.0
    z = ((a - 1.0) * p + 1.0) ** 2 / a
    assert stats.kstest(z, lambda t: (np.sqrt(np.clip(t, 1 / a, a) * a) - 1.0) / (a - 1.0)).pvalue > 1e-3


def test_partner_draws_prefer_finite_walkers():
    from albatross_tpu_torch.samplers.ensemble import draw_half_step

    g = torch.Generator().manual_seed(1)
    lp = torch.tensor([0.0, -torch.inf, -1.0, torch.nan], dtype=torch.float64)
    picks = draw_half_step(g, 4000, lp).partners
    assert set(picks.tolist()) == {0, 2}
    none_finite = draw_half_step(g, 4000, torch.full((3,), -torch.inf, dtype=torch.float64)).partners
    assert set(none_finite.tolist()) == {0, 1, 2}  # uniform over all


def _posterior_problem(rng, n):
    x = np.sort(rng.uniform(0.0, 20.0, n))
    K = 1.5**2 * np.exp(-(((x[:, None] - x[None, :]) / 2.0) ** 2)) + 0.1**2 * np.eye(n)
    y = np.linalg.cholesky(K + 1e-12 * np.eye(n)) @ rng.standard_normal(n)
    kernel = pt.SquaredExponential(2.0, 1.5) + pt.measurement_only(pt.IndependentNoise(0.1))
    kernel = kernel.set_param_prior("squared_exponential_length_scale", pt.LogScaleUniformPrior(1e-2, 1e3))
    kernel = kernel.set_param_prior("sigma_squared_exponential", pt.LogScaleUniformPrior(1e-2, 1e3))
    kernel = kernel.set_param_prior("sigma_independent_noise", pt.FixedPrior())
    data = pt.RegressionDataset.create(torch.as_tensor(x), torch.as_tensor(y))
    return pt.gp_from_covariance(kernel), data


def test_ensemble_sampler_posterior():
    """The JAX package's posterior test (tests/test_tuning_samplers.py):
    data drawn from a GP with length scale 2; the posterior over it covers
    the truth."""
    model, data = _posterior_problem(np.random.default_rng(2012), 25)
    chain = ensemble_sampler_from_model(model, data, n_walkers=12, max_iterations=60, key=5)
    assert chain.params.shape == (61, 12, 2)
    assert 0.05 < chain.acceptance_rate() < 0.95
    assert np.median(chain.log_prob[-1]) >= np.median(chain.log_prob[0]) - 5.0
    names = model.get_tunable_parameters().names
    ls = np.exp(chain.flat_samples(burn_in=30)[:, names.index("squared_exponential_length_scale")])
    assert np.quantile(ls, 0.05) < 2.0 < np.quantile(ls, 0.95)


def test_csv_callback_text_matches_jax():
    rng = np.random.default_rng(4)
    names = ["a", "b", "c"]
    jstream, tstream = io.StringIO(), io.StringIO()
    jcb, tcb = JaxCsvWritingCallback(jstream, names), CsvWritingCallback(tstream, names)
    for i in range(3):
        params, lp = rng.standard_normal((5, 3)), rng.standard_normal(5)
        lp[2] = -np.inf
        jcb(i, jax_ensemble.SamplerState(jnp.asarray(params), jnp.asarray(lp), jnp.ones(5, dtype=bool)))
        tcb(i, SamplerState(torch.as_tensor(params), torch.as_tensor(lp), torch.ones(5, dtype=torch.bool)))
    assert tstream.getvalue() == jstream.getvalue()


def test_callbacks_fire_every_iteration_and_the_chain_ignores_the_interval(tmp_path):
    init = torch.as_tensor(np.random.default_rng(11).standard_normal((8, 2)))
    plain = ensemble_sampler(_gaussian_torch, init, 10, key=11)
    seen = []
    chunked = ensemble_sampler(_gaussian_torch, init, 10, key=11,
                               callback=lambda i, s: seen.append(i), callback_interval=3)
    np.testing.assert_array_equal(plain.params, chunked.params)
    np.testing.assert_array_equal(plain.log_prob, chunked.log_prob)
    assert seen == list(range(11))

    class Boom(RuntimeError):
        pass

    path = tmp_path / "chain.csv"
    with open(path, "w", newline="") as fh:
        cb = CsvWritingCallback(fh, ["a", "b"])

        def crashing(i, s):
            if i == 7:
                raise Boom()
            cb(i, s)
            # flushed mid-run: the file already holds every row so far
            assert len(path.read_text().strip().splitlines()) == 1 + (i + 1) * 8

        with pytest.raises(Boom):
            ensemble_sampler(_gaussian_torch, init, 10, key=11, callback=crashing, callback_interval=3)
    assert len(path.read_text().strip().splitlines()) == 1 + 7 * 8


def test_tracking_and_null_callbacks():
    model, data = _posterior_problem(np.random.default_rng(3), 15)
    tracker = MaximumLikelihoodTrackingCallback()
    stream = io.StringIO()
    csv_cb = CsvWritingCallback(stream, model.get_tunable_parameters().names)

    def both(i, state):
        NullCallback()(i, state)
        tracker(i, state)
        csv_cb(i, state)

    chain = ensemble_sampler_from_model(model, data, n_walkers=8, max_iterations=10, key=3, callback=both)
    assert np.isfinite(tracker.best_log_prob) and tracker.best_log_prob == np.max(chain.log_prob)
    lines = stream.getvalue().strip().split("\n")
    assert len(lines) == 1 + 11 * 8
    assert lines[0].startswith("iteration,ensemble_index,log_probability")


def test_chain_container():
    chain = ensemble_sampler(_gaussian_torch, torch.zeros((6, 2), dtype=torch.float64) + 0.1 * torch.arange(
        12, dtype=torch.float64).reshape(6, 2), 4, key=torch.Generator().manual_seed(2))
    assert isinstance(chain, EnsembleChain) and len(chain) == 5
    assert chain.flat_samples(burn_in=2).shape == (18, 2)
    state = chain.state(3)
    np.testing.assert_array_equal(state.params.numpy(), chain.params[3])
    assert chain.accepted[0].all()
    assert chain.acceptance_rate() == pytest.approx(float(np.mean(chain.accepted[1:])))


def test_initial_params_from_jitter():
    values = torch.tensor([0.5, -1.0], dtype=torch.float64)
    walkers = initial_params_from_jitter(3, values, 5000, jitter_sd=0.2)
    assert walkers.shape == (5000, 2) and walkers.dtype == torch.float64
    np.testing.assert_allclose(walkers.mean(0).numpy(), values.numpy(), atol=0.02)
    np.testing.assert_allclose(walkers.std(0).numpy(), 0.2, rtol=0.05)
    assert torch.equal(walkers, initial_params_from_jitter(3, values, 5000, jitter_sd=0.2))


def test_sampler_routes_and_refusals(monkeypatch):
    """A mesh without the named axis raises (tests/test_torch_parallel.py
    runs the walker-sharded chain); at or above CHOLESKY_FUSED_MIN_N the batched route
    refuses; a sparse GP and a safe-factorization GP take the per-walker
    loop and equal their log_likelihood."""
    model, data = _posterior_problem(np.random.default_rng(6), 20)
    with pytest.raises(ValueError, match="no axis 'chain'"):
        ensemble_sampler_from_model(model, data, 4, 2, key=0, mesh=object())
    walkers = initial_params_from_jitter(1, model.get_tunable_parameters().values, 4)
    monkeypatch.setattr(config, "CHOLESKY_FUSED_MIN_N", 16)
    with pytest.raises(ValueError, match="CHOLESKY_FUSED_MIN_N"):
        model_log_prob_fn(model, data)(walkers)
    monkeypatch.undo()
    safe = pt.gp_from_covariance(model.covariance_function, safe_factorization=True)
    with pytest.raises(ValueError, match="safe_factorization"):
        GaussianProcess.batched_log_likelihood([safe], data)
    got = model_log_prob_fn(safe, data)(walkers)
    ref = [float(safe.set_tunable_params(w).log_likelihood(data)) for w in walkers]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    sparse = pt.sparse_gp_from_covariance(model.covariance_function, pt.UniformlySpacedInducingPoints(8))
    walkers = initial_params_from_jitter(2, sparse.get_tunable_parameters().values, 4)
    got = model_log_prob_fn(sparse, data)(walkers)
    ref = [float(sparse.set_tunable_params(w).log_likelihood(data)) for w in walkers]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
