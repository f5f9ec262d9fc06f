"""Port parity of the 2-D tile layout and the distributed sparse GP on a
gloo world of 8 processes, against the JAX package on its 8 virtual CPU
devices (tests/conftest.py), f64.

One world serves the whole file: a module-scoped fixture spawns the 8
ranks (``tests/test_torch_parallel_2d_ranks.py``, a ``file://`` rendezvous
under ``tmp_path``, one torch thread a rank); they build a (4, 2)
("data", "model") mesh, held against the JAX package's ``mesh2d`` of
tests/test_parallel.py (not square, so swapped tile sides show), and the
1-D mesh of 8, held against its ``mesh``.  Each rank runs every check on
the same numpy inputs and writes its results; each test holds one check's
results, from every rank, against the JAX package and the port's
single-process path.  The cases mirror tests/test_parallel.py's 2-D and
sparse ones, plus PITC groups that straddle the ranks' rows, duplicated
inputs under ``assume_unique`` on the 2-D gram and the distributed sparse
NLML gradient.  Tolerances: the same algorithms in f64 on both sides, so
1e-9 relative to the largest entry (condition numbers ~1e3 over ~1e-16
rounding); the TSQR's R at 1e-7 after sign canonicalisation, as the JAX
package holds it; grams 1e-12.
"""

import multiprocessing
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import albatross_tpu as ab
from albatross_tpu.evaluation.cross_validation_utils import held_out_predictions
from albatross_tpu.indexing import KFoldGrouper, LeaveOneOutGrouper, group_by
from albatross_tpu.models.sparse_gp import UniformlySpacedInducingPoints, sparse_gp_from_covariance
from albatross_tpu.parallel import (
    DistributedGaussianProcess,
    distributed_cholesky_2d,
    distributed_gp_from_covariance,
    distributed_inverse_blocks_2d,
    distributed_inverse_diagonal_2d,
    distributed_log_determinant_2d,
    distributed_solve_2d,
    distributed_sparse_gp_from_covariance,
    distributed_sqrt_solve_2d,
    distributed_tall_qr,
    distributed_tri_inverse_2d,
    make_mesh,
    sharded_gram_2d,
)

import test_torch_parallel_2d_ranks as ranks

torch.set_num_threads(2)
WORLD = 8
R, C = 4, 2
RTOL = 1e-9


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _inputs(tmp):
    rng = np.random.default_rng(2013)
    x_dup = np.sort(rng.uniform(0, 10, 40))
    x_dup[[7, 23, 38]] = x_dup[[6, 31, 2]]  # duplicated inputs inside and across tiles
    gp_x, grad_x = (np.sort(rng.uniform(0, 10, n)) for n in (32, 16))
    up1, up2 = np.sort(rng.uniform(0, 10, 64)), np.sort(rng.uniform(0, 10, 16))
    sx = np.sort(rng.uniform(0, 10, 256))
    return {
        "x40": np.sort(rng.uniform(0, 10, 40)), "x_dup": x_dup, "x64": np.sort(rng.uniform(0, 10, 64)),
        "A64": _spd(rng, 64), "RHS64": rng.standard_normal((64, 48)), "A192": _spd(rng, 192),
        "RHS64_33": rng.standard_normal((64, 33)), "RHS192_33": rng.standard_normal((192, 33)),
        "A256": _spd(rng, 256), "A30": _spd(rng, 30),
        "groups64": [np.arange(3, 9), np.array([60, 1, 33]), np.array([17, 40, 2]), np.arange(28, 36)],
        "gp": (gp_x, np.sin(gp_x) + 0.1 * rng.standard_normal(32)), "xs8": np.linspace(0.5, 9.5, 8),
        "grad": (grad_x, np.sin(grad_x)),
        "update": ((up1, np.sin(up1)), (up2, np.sin(up2)), np.linspace(0, 10, 40)),
        "B128": rng.standard_normal((128, 12)), "extra12": rng.standard_normal((12, 12)),
        "x_sparse": np.sort(rng.uniform(0, 10, 512)),
        "sparse": (sx, np.sin(sx) + 0.1 * rng.standard_normal(256)), "xs_sparse": np.linspace(0.5, 9.5, 40),
        "ckpt_dir": str(tmp),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the results of each rank)."""
    tmp = tmp_path_factory.mktemp("gloo_world_2d")
    inputs = _inputs(tmp)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.run,
                         args=(r, WORLD, str(tmp / "rendezvous"), str(tmp), str(tmp / "inputs.pkl")))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    alive = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not alive, f"ranks still running after 240 s: {alive}"
    results = []
    for r in range(WORLD):
        path = tmp / f"rank{r}.pkl"
        assert os.path.exists(path), f"rank {r} wrote no result (exit code {procs[r].exitcode})"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert res["ok"], f"rank {r} failed:\n{res['error']}"
        results.append(res["out"])
    return inputs, results


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(WORLD, ("data",))


@pytest.fixture(scope="module")
def jmesh2d():
    return make_mesh(WORLD, ("data", "model"), shape=(R, C))


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
    assert err <= rtol, err


def _tiles(results, key):
    """The whole matrix from each rank's tile (rank r is (r // C, r % C))."""
    return np.block([[results[i * C + j][key] for j in range(C)] for i in range(R)])


def _replicated(results, key):
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], first)
    return first


def test_sharded_gram_2d_matches_jax_and_the_dense_gram(world, jmesh2d):
    """Each rank builds its (10, 20) tile; the tiles assemble to the JAX
    package's 2-D gram and to the single-process gram plus the target
    variance."""
    inputs, results = world
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2))
    K = sharded_gram_2d(kernel, jnp.asarray(inputs["x40"]), jmesh2d, measurement=True,
                        target_variance=jnp.full((40,), 0.01))
    assert K.sharding.shard_shape(K.shape) == results[0]["gram2d"].shape == (10, 20)
    _close(_tiles(results, "gram2d"), K, rtol=1e-12)
    _close(_tiles(results, "gram2d"), results[0]["gram2d_single"], rtol=1e-12)
    assert results[0]["gram2d_placements"] == ["S(0)", "S(1)"]


def test_duplicate_inputs_follow_the_2d_path(world, jmesh2d):
    """Under assume_unique=True the tiles compare features by value, as
    the JAX package's 2-D shard_map does: each duplicated pair gets sigma^2
    off the diagonal, where the single-process gram's identity shortcut
    puts none."""
    inputs, results = world
    unique = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2, assume_unique=True))
    K = _tiles(results, "gram2d_dup")
    _close(K, sharded_gram_2d(unique, jnp.asarray(inputs["x_dup"]), jmesh2d, measurement=True), rtol=1e-12)
    diff = K - results[0]["gram2d_dup_single"]
    assert sorted(zip(*np.nonzero(diff))) == [(2, 38), (6, 7), (7, 6), (23, 31), (31, 23), (38, 2)]
    np.testing.assert_allclose(diff[6, 7], 0.04, rtol=1e-12)


def test_distributed_cholesky_2d_and_its_pieces_match_jax(world, jmesh2d):
    inputs, results = world
    groups = inputs["groups64"]

    def ref(A, RHS, x):
        L = distributed_cholesky_2d(A, jmesh2d)
        K = sharded_gram_2d(ab.SquaredExponential(1.0, 1.0) + ab.IndependentNoise(1.0), x, jmesh2d)
        return (L, distributed_solve_2d(L, RHS[:, :3], jmesh2d), distributed_sqrt_solve_2d(L, RHS[:, 0], jmesh2d),
                distributed_log_determinant_2d(L, jmesh2d), distributed_inverse_diagonal_2d(L, jmesh2d),
                distributed_inverse_blocks_2d(L, groups, jmesh2d), distributed_tri_inverse_2d(L, jmesh2d),
                distributed_cholesky_2d(K, jmesh2d, panel=8))

    L, x, w, ld, diag, blocks, W, L_tiles = jax.jit(ref)(
        *(jnp.asarray(inputs[k]) for k in ("A64", "RHS64", "x64")))
    got = _tiles(results, "chol2d")
    assert results[0]["chol2d"].shape == L.sharding.shard_shape(L.shape) == (16, 32)
    _close(got, L)
    _close(got, np.linalg.cholesky(inputs["A64"]))
    assert np.array_equal(got, np.tril(got))
    _close(_tiles(results, "chol2d_from_tiles"), L_tiles)
    _close(_replicated(results, "solve2d"), x)
    _close(_replicated(results, "sqrt_solve2d"), w)
    assert _replicated(results, "log_det2d") == pytest.approx(float(ld), rel=1e-12)
    _close(_replicated(results, "inverse_diagonal2d"), diag)
    _close(_tiles(results, "tri_inverse2d"), W)
    inv = np.linalg.inv(inputs["A64"])
    for r in results:
        for got_b, want, idx in zip(r["inverse_blocks2d"], blocks, groups):
            _close(got_b, want)
            _close(got_b, inv[np.ix_(idx, idx)])


def test_2d_solve_routes_match_jax_and_each_other(world, jmesh2d):
    """The inverse, substitution and auto routes of both solves against the
    JAX package's; a vector stays on the substitution route under auto."""
    inputs, results = world

    def ref(A, RHS):
        L = distributed_cholesky_2d(A, jmesh2d)
        out = {mode: (distributed_sqrt_solve_2d(L, RHS, jmesh2d, mode=mode),
                      distributed_solve_2d(L, RHS, jmesh2d, mode=mode)) for mode in ("inverse", "substitution")}
        return out, distributed_solve_2d(L, RHS[:, 5], jmesh2d, mode="auto")

    want, vec = jax.jit(ref)(jnp.asarray(inputs["A64"]), jnp.asarray(inputs["RHS64"]))
    want["auto"] = want["inverse"]  # 48 right-hand sides
    for mode in ("inverse", "substitution", "auto"):
        y, x = _replicated(results, f"wsolve_{mode}")
        _close(y, want[mode][0])
        _close(x, want[mode][1])
    _close(_replicated(results, "wsolve_vector"), vec)
    _close(results[0]["wsolve_substitution"][1], np.linalg.solve(inputs["A64"], inputs["RHS64"]))


def test_2d_auto_routes_multi_rhs_through_inverse(world):
    """With W_SOLVE_MIN_RHS right-hand sides auto never reaches the
    substitution (the ranks replaced it with a function that raises)."""
    inputs, results = world
    _close(_replicated(results, "auto_wide"), np.linalg.solve(inputs["A64"], inputs["RHS64"][:, :32]))


def test_2d_solve_round_complexity(world):
    """The port's all-reduces a solve runs: both routes' counts do not grow
    with N (q-blocks grow with the tiles), and the inverse route needs
    fewer than the substitution on this 4 x 2 mesh."""
    _, results = world
    rounds = results[0]["rounds"]
    for r in results:
        assert r["rounds"] == rounds
    assert rounds["inverse", 64] == rounds["inverse", 192]
    assert rounds["substitution", 64] == rounds["substitution", 192]
    assert rounds["inverse", 64] < rounds["substitution", 64], rounds


def test_no_rank_writes_an_n_squared_tensor(world):
    """The card's memory claim on the CPU: at N = 256 the largest tensor
    any op writes during the 2-D factorization is the (N, panel) panel or
    the tile, shrinking with the panel width, and the fast-LOO engine's is
    below N^2 (the JAX test reads XLA's temp bytes instead)."""
    _, results = world
    n = 256
    for r in results:
        largest = r["largest"]
        assert largest["tile"] == (n // R, n // C)
        assert largest[128] == n * 128
        assert largest[32] < largest[128] / 2
        assert largest[32] < n * n // 2
        assert largest["inverse_diagonal"] < n * n // 2


def test_distributed_gp_2d_matches_jax_and_the_single_process_gp(world, jmesh2d):
    """Fit, predict, NLML, fast LOO and LOGO of the 2-D layout against the
    JAX package's 2-D model and the port's single-process GP."""
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["gp"])
    data = ab.RegressionDataset.create(x, y, variance=jnp.full((32,), 0.01))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2))
    loo_idx = group_by(data, LeaveOneOutGrouper()).indexers()
    logo_idx = group_by(data, KFoldGrouper(4)).indexers()
    multi = distributed_gp_from_covariance(kernel, jmesh2d, col_axis="model")

    def ref():
        fit = multi.fit(data)
        p = fit.predict(jnp.asarray(inputs["xs8"])).marginal()
        f = fit.fit
        loo = held_out_predictions(f.train_covariance, data.targets.mean, f.information, loo_idx, None)
        logo = held_out_predictions(f.train_covariance, data.targets.mean, f.information, logo_idx,
                                    ab.JointDistribution)
        return (p.mean, p.variance, multi.log_likelihood(data), {k: loo[k] for k in loo_idx},
                {k: (logo[k].mean, logo[k].covariance) for k in logo_idx})

    mean, variance, ll, loo, logo = jax.jit(ref)()
    for name in ("gp_multi", "gp_single"):
        got_mean, got_var, got_ll = results[0][name]
        for r in results:
            np.testing.assert_array_equal(r[name][0], got_mean)
        _close(got_mean, mean)
        _close(got_var, variance)
        assert got_ll == pytest.approx(float(ll), rel=RTOL)
    for r in results:
        for name in ("loo_multi", "loo_single"):
            assert sorted(r[name]) == sorted(loo_idx.keys())
            for k in loo_idx:
                _close(r[name][k], loo[k])
        for name in ("logo_multi", "logo_single"):
            for k in logo_idx:
                _close(r[name][k][0], logo[k][0])
                _close(r[name][k][1], logo[k][1])


def test_distributed_gp_2d_gradient_matches_jax_on_every_rank(world, jmesh2d):
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["grad"])
    data = ab.RegressionDataset.create(x, y)
    multi = distributed_gp_from_covariance(ab.SquaredExponential(2.0, 1.0) + ab.IndependentNoise(0.1), jmesh2d,
                                           col_axis="model")
    x0 = multi.get_tunable_parameters().values
    ref_v, ref_g = jax.jit(jax.value_and_grad(lambda v: -multi.set_tunable_params(v).log_likelihood(data)))(x0)
    value, grad = results[0]["grad_multi"]
    for r in results:
        assert r["grad_multi"][0] == value
        np.testing.assert_array_equal(r["grad_multi"][1], grad)
    assert value == pytest.approx(float(ref_v), rel=RTOL)
    _close(grad, ref_g)
    _close(grad, results[0]["grad_single"][1])


def test_distributed_update_matches_jax_and_a_refit_in_both_layouts(world, jmesh2d):
    """update on a fit of each layout over the (4, 2) mesh against the JAX
    package's and a single-process refit on all the data."""
    inputs, results = world
    (x1, y1), (x2, y2), xs = inputs["update"]
    var = lambda n: jnp.full((n,), 0.01)  # noqa: E731
    d1 = ab.RegressionDataset.create(jnp.asarray(x1), jnp.asarray(y1), variance=var(len(x1)))
    d2 = ab.RegressionDataset.create(jnp.asarray(x2), jnp.asarray(y2), variance=var(len(x2)))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1)
    for layout, kw in (("1d", {}), ("2d", {"col_axis": "model"})):
        model = DistributedGaussianProcess(kernel, jmesh2d, axis="data", **kw)
        p = jax.jit(lambda: model.fit(d1).update(d2).predict(jnp.asarray(xs)).marginal())()
        for r in results:
            mean, variance, twice_finite = r[f"update_{layout}"]
            _close(mean, p.mean)
            _close(variance, p.variance)
            _close(mean, r["refit"][0], rtol=1e-10)
            _close(variance, r["refit"][1], rtol=1e-9)
            assert twice_finite


def test_checkpoint_of_a_2d_fit_keeps_its_tiles(world):
    _, results = world
    for r in results:
        before, after, placements = r["checkpoint"]
        np.testing.assert_array_equal(after, before)
        assert placements == ["S(0)", "S(1)"]


def test_distributed_tall_qr_matches_jax(world, jmesh):
    inputs, results = world
    B, extra = jnp.asarray(inputs["B128"]), jnp.asarray(inputs["extra12"])
    want = distributed_tall_qr(B, jmesh, "data", extra=extra)
    got = _replicated(results, "tsqr")
    _close(got, want, rtol=1e-7)
    assert np.all(np.diag(got) >= 0)
    BtB = inputs["B128"].T @ inputs["B128"] + inputs["extra12"].T @ inputs["extra12"]
    _close(got.T @ got, BtB)
    K = np.asarray(ab.SquaredExponential(2.0, 1.0).matrix_or_none(jnp.asarray(inputs["x_sparse"][:128]),
                                                                    jnp.linspace(0, 10, 12)))
    _close(_replicated(results, "tsqr_sharded"), distributed_tall_qr(jnp.asarray(K), jmesh, "data"), rtol=1e-7)


@pytest.mark.parametrize("name,size", [("fitc", None), ("pitc32", 32), ("pitc24", 24)])
def test_distributed_sparse_gp_matches_jax_and_the_single_process_fit(world, jmesh, name, size):
    """FITC, PITC with groups on the ranks' row boundaries (32 of 256 rows
    over 8 ranks) and PITC with groups of 24 that straddle them: the
    predictions and NLML against the JAX package's distributed and
    single-process sparse GPs, R (sign-canonicalised) against the JAX
    package's distributed R, and the NLML gradient against the port's
    single-process one."""
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["sparse"])
    data = ab.RegressionDataset.create(x, y, variance=jnp.full((256,), 0.01))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.IndependentNoise(0.1)
    kw = dict(inducing_point_strategy=UniformlySpacedInducingPoints(24))
    if size is not None:
        kw["grouper"] = lambda features: np.arange(len(np.asarray(features))) // size
    fit = distributed_sparse_gp_from_covariance(kernel, jmesh, **kw).fit(data)
    p = fit.predict(jnp.asarray(inputs["xs_sparse"])).marginal()
    # the JAX package holds its distributed NLML to its single-process one
    # at 1e-10 (test_distributed_sparse_gp_ladder); the latter is quicker
    ll = float(sparse_gp_from_covariance(kernel, **kw).log_likelihood(data))
    for which in ("multi", "single"):
        mean, variance, neg_ll, grad, R_fit = results[0][f"sparse_{name}_{which}"]
        for r in results[1:]:
            np.testing.assert_array_equal(r[f"sparse_{name}_{which}"][0], mean)
        _close(mean, p.mean)
        _close(variance, p.variance)
        assert -neg_ll == pytest.approx(ll, rel=RTOL)
    R_multi = results[0][f"sparse_{name}_multi"][4]
    _close(R_multi, fit.fit.R, rtol=1e-7)
    assert np.all(np.diag(R_multi) >= 0)
    _close(results[0][f"sparse_{name}_multi"][3], results[0][f"sparse_{name}_single"][3])
    assert np.all(np.isfinite(results[0][f"sparse_{name}_multi"][3]))


def test_distributed_sparse_update_and_sharding(world):
    """update over the gathered K_fu equals the single-process update; K_fu
    stays row-sharded, (N/8, M) a rank."""
    _, results = world
    for r in results:
        multi, single = r["sparse_update"]
        _close(multi, single)
        assert r["kfu_local"] == (512 // WORLD, 16)


def test_errors_match_jax(world):
    _, results = world
    errors = results[0]["errors"]
    assert errors["cholesky2d"] == "ValueError: N=30 not divisible by mesh axes (4, 2)"
    assert errors["gram2d"] == "ValueError: N=30 not divisible by mesh axes (4, 2)"
    assert errors["tri_inverse2d"] == "ValueError: N=30 not divisible by mesh axes (4, 2)"
    assert errors["panel"] == "ValueError: panel=24 must divide the tile width 32"
    assert errors["tsqr_divisible"] == "ValueError: N=100 not divisible by mesh axis size 8"
    assert errors["tsqr_rows"] == "ValueError: TSQR needs n/D >= m rows per device (got 2 < 12)"
    assert errors["mode"].startswith("ValueError: mode must be")
