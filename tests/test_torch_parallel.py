"""Port parity of the 1-D row-sharded ``parallel`` package on a gloo world
of 4 processes, against the JAX package on its mesh of 4 virtual CPU
devices (tests/conftest.py), f64.

One world serves the whole file: a module-scoped fixture spawns the 4
ranks (``tests/test_torch_parallel_ranks.py``, a ``file://`` rendezvous under
``tmp_path``), each runs every check on the same numpy inputs and writes
its results; each test then holds one check's results, from every rank,
against the JAX package and the port's single-process path.  The cases
mirror the 1-D ones of tests/test_parallel.py.  Tolerances: the same
algorithm in f64 on both sides, so 1e-9 relative to the largest entry (a
condition number of ~1e3 over ~1e-16 rounding); the sampler's sharded
chain equals the unsharded one to 1e-10; the sharded gram equals the
single-process gram bit for bit.
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
from albatross_tpu.kernels import as_measurement
from albatross_tpu.parallel import (
    distributed_cholesky,
    distributed_gp_from_covariance,
    distributed_inverse_blocks,
    distributed_inverse_diagonal,
    distributed_log_determinant,
    distributed_solve,
    distributed_sqrt_solve,
    make_mesh,
    sharded_cross_gram,
    sharded_gram,
)

import test_torch_parallel_ranks as ranks

torch.set_num_threads(2)
WORLD = 4
RTOL = 1e-9


def _spd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def _inputs(tmp):
    rng = np.random.default_rng(2012)
    bits = np.random.default_rng(22)
    bitwise = []
    for n in (512, 1024):
        bitwise.append((bits.uniform(-1.0, 1.0, n), bits.uniform(-1.0, 1.0, int(bits.integers(100, 500)))))
    x_dup = np.sort(rng.uniform(0, 10, 40))
    x_dup[[7, 23]] = x_dup[[6, 31]]  # two duplicated inputs, across ranks' rows
    update = ((np.sort(rng.uniform(0, 10, 64)),), (np.sort(rng.uniform(0, 10, 16)),))
    gp_x, grad_x, cv_x, s_x = (np.sort(rng.uniform(0, 10, n)) for n in (32, 16, 24, 12))
    return {
        "A64": _spd(rng, 64), "A48": _spd(rng, 48), "rhs48": rng.standard_normal(48),
        "RHS48": rng.standard_normal((48, 3)), "A32": _spd(rng, 32), "A30": _spd(rng, 30),
        "groups32": [np.arange(4), np.arange(8, 12), np.array([30, 31, 5, 6]), np.array([1, 17, 2, 25, 9])],
        "x40": np.sort(rng.uniform(0, 10, 40)), "xs5": np.linspace(0, 10, 5), "bitwise": bitwise,
        "x_dup": x_dup,
        "gp": (gp_x, np.sin(gp_x) + 0.1 * rng.standard_normal(32)), "xs8": np.linspace(0.5, 9.5, 8),
        "grad": (grad_x, np.sin(grad_x)),
        "cv": (cv_x, np.sin(cv_x) + 0.1 * rng.standard_normal(24)),
        "update": ((update[0][0], np.sin(update[0][0])), (update[1][0], np.sin(update[1][0])),
                   np.linspace(0, 10, 40)),
        "sampler": s_x, "ckpt_dir": str(tmp),
    }


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the results of each rank)."""
    tmp = tmp_path_factory.mktemp("gloo_world")
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


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)
    assert err <= rtol, err


def _replicated(results, key):
    """The value every rank returned for ``key``, checked equal across ranks."""
    first = results[0][key]
    for r in results[1:]:
        np.testing.assert_array_equal(np.asarray(r[key], dtype=object) if isinstance(first, list) else r[key],
                                      np.asarray(first, dtype=object) if isinstance(first, list) else first)
    return first


def _rows(results, key):
    return np.concatenate([r[key] for r in results])


def test_distributed_cholesky_matches_jax(world, jmesh):
    inputs, results = world
    L = _rows(results, "chol_local")
    _close(L, distributed_cholesky(jnp.asarray(inputs["A64"]), jmesh))
    _close(L, np.linalg.cholesky(inputs["A64"]))
    assert np.array_equal(L, np.tril(L))
    assert results[0]["chol_placements"] == [True]  # Shard(0) on the mesh's one axis


def test_distributed_solves_and_log_determinant_match_jax(world, jmesh):
    inputs, results = world
    def ref(A, rhs, RHS):
        L = distributed_cholesky(A, jmesh)
        return (distributed_solve(L, rhs, jmesh), distributed_solve(L, RHS, jmesh),
                distributed_sqrt_solve(L, rhs, jmesh), distributed_log_determinant(L, jmesh))

    x, X, w, ld = jax.jit(ref)(*(jnp.asarray(inputs[k]) for k in ("A48", "rhs48", "RHS48")))
    _close(_replicated(results, "solve"), x)
    _close(_replicated(results, "solve_matrix"), X)
    _close(_replicated(results, "sqrt_solve"), w)
    assert _replicated(results, "log_det") == pytest.approx(float(ld), rel=1e-12)
    _close(results[0]["solve_matrix"], np.linalg.solve(inputs["A48"], inputs["RHS48"]))


def test_distributed_inverse_pieces_match_jax(world, jmesh):
    inputs, results = world
    diag, ref = jax.jit(lambda A: (lambda L: (distributed_inverse_diagonal(L, jmesh),
                                              distributed_inverse_blocks(L, inputs["groups32"], jmesh)))(
        distributed_cholesky(A, jmesh)))(jnp.asarray(inputs["A32"]))
    _close(_replicated(results, "inverse_diagonal"), diag)
    inv = np.linalg.inv(inputs["A32"])
    for r in results:
        for got, want, idx in zip(r["inverse_blocks"], ref, inputs["groups32"]):
            _close(got, want)
            _close(got, inv[np.ix_(idx, idx)])


def test_sharded_grams_match_jax_and_the_single_process_gram(world, jmesh):
    """The measurement gram with and without target variance and the cross
    gram against the JAX package's sharded grams; the port's sharded gram
    of SE(0.5, 0.1) equals its single-process gram bit for bit, as the JAX
    package's does (test_parallel_gram_bitwise_equals_serial)."""
    inputs, results = world
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2))
    x = jnp.asarray(inputs["x40"])
    _close(_rows(results, "gram"), sharded_gram(kernel, x, jmesh, measurement=True), rtol=1e-12)
    _close(_rows(results, "gram_var"),
           sharded_gram(kernel, x, jmesh, measurement=True, target_variance=jnp.full((40,), 0.01)), rtol=1e-12)
    _close(_rows(results, "cross"), sharded_cross_gram(kernel, x, jnp.asarray(inputs["xs5"]), jmesh), rtol=1e-12)
    np.testing.assert_array_equal(_rows(results, "gram"), results[0]["gram_single"])
    for i in range(len(inputs["bitwise"])):
        np.testing.assert_array_equal(np.concatenate([r[f"bitwise_gram{i}"][0] for r in results]),
                                      results[0][f"bitwise_gram{i}"][1])
        np.testing.assert_array_equal(np.concatenate([r[f"bitwise_cross{i}"][0] for r in results]),
                                      results[0][f"bitwise_cross{i}"][1])


def test_duplicate_inputs_follow_each_path(world, jmesh):
    """Under assume_unique=True a duplicated input puts sigma^2 off the
    diagonal of the sharded gram (features compared by value, as the JAX
    package's shard_map does), where the single-process gram takes the
    identity shortcut: the port reproduces both matrices."""
    inputs, results = world
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2, assume_unique=True))
    x = jnp.asarray(inputs["x_dup"])
    sharded = _rows(results, "gram_dup")
    _close(sharded, sharded_gram(kernel, x, jmesh, measurement=True), rtol=1e-12)
    _close(results[0]["gram_dup_single"], kernel(as_measurement(x)), rtol=1e-12)
    diff = sharded - results[0]["gram_dup_single"]
    assert sorted(zip(*np.nonzero(diff))) == [(6, 7), (7, 6), (23, 31), (31, 23)]
    np.testing.assert_allclose(diff[6, 7], 0.04, rtol=1e-12)


def test_distributed_gp_matches_jax_and_the_single_process_gp(world, jmesh):
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["gp"])
    data = ab.RegressionDataset.create(x, y, variance=jnp.full((32,), 0.01))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2))
    multi = distributed_gp_from_covariance(kernel, jmesh)
    # jitted: one compile instead of one a shard_map call
    p, ll = jax.jit(lambda: (multi.fit(data).predict(jnp.asarray(inputs["xs8"])).marginal(),
                             multi.log_likelihood(data)))()
    ll = float(ll)
    for name in ("gp_multi", "gp_single"):
        mean, var, got_ll = results[0][name]
        for r in results:
            np.testing.assert_array_equal(r[name][0], mean)
        _close(mean, p.mean)
        _close(var, p.variance)
        assert got_ll == pytest.approx(ll, rel=RTOL)


def test_distributed_gradient_matches_jax_on_every_rank(world, jmesh):
    """-log_likelihood and its gradient with respect to the tunable vector,
    the same on every rank, against jax.grad of the JAX package's
    distributed model and the port's single-process gradient."""
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["grad"])
    data = ab.RegressionDataset.create(x, y)
    multi = distributed_gp_from_covariance(ab.SquaredExponential(2.0, 1.0) + ab.IndependentNoise(0.1), jmesh)
    x0 = multi.get_tunable_parameters().values
    ref_v, ref_g = jax.jit(jax.value_and_grad(lambda v: -multi.set_tunable_params(v).log_likelihood(data)))(x0)
    value, grad = results[0]["grad_multi"]
    for r in results:
        assert r["grad_multi"][0] == value
        np.testing.assert_array_equal(r["grad_multi"][1], grad)
    assert value == pytest.approx(float(ref_v), rel=RTOL)
    _close(grad, ref_g)
    _close(grad, results[0]["grad_single"][1])


def test_distributed_loo_and_logo_match_jax(world, jmesh):
    inputs, results = world
    x, y = (jnp.asarray(v) for v in inputs["cv"])
    data = ab.RegressionDataset.create(x, y, variance=jnp.full((24,), 0.01))
    kernel = ab.SquaredExponential(1.5, 1.0) + ab.measurement_only(ab.IndependentNoise(0.2))
    loo_idx = group_by(data, LeaveOneOutGrouper()).indexers()
    logo_idx = group_by(data, KFoldGrouper(4)).indexers()

    def both():
        fit = distributed_gp_from_covariance(kernel, jmesh).fit(data).fit
        loo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information, loo_idx, None)
        logo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information, logo_idx,
                                    ab.JointDistribution)
        return {k: loo[k] for k in loo_idx}, {k: (logo[k].mean, logo[k].covariance) for k in logo_idx}

    loo, logo = jax.jit(both)()
    for r in results:
        for name in ("loo_multi", "loo_single"):
            assert sorted(r[name]) == sorted(loo_idx.keys())
            for k in loo_idx:
                _close(r[name][k], loo[k])
        for name in ("logo_multi", "logo_single"):
            for k in logo_idx:
                _close(r[name][k][0], logo[k][0])
                _close(r[name][k][1], logo[k][1])


def test_distributed_update_matches_a_refit(world):
    """update on a distributed fit (a BlockSymmetric over the sharded
    factor) against a single-process refit on all the data."""
    _, results = world
    for r in results:
        _close(r["update"][0], r["refit"][0], rtol=1e-10)
        _close(r["update"][1], r["refit"][1], rtol=1e-9)
        assert r["update_twice_finite"]


def test_walker_sharded_sampler_matches_the_unsharded_chain(world):
    _, results = world
    plain_lp, sharded_lp, plain_p, sharded_p = results[0]["sampler"]
    np.testing.assert_allclose(sharded_lp, plain_lp, rtol=1e-10)
    np.testing.assert_allclose(sharded_p, plain_p, rtol=1e-10)
    assert sharded_lp.shape == (9, 16) and np.isfinite(sharded_lp).all()
    for r in results[1:]:
        np.testing.assert_array_equal(r["sampler"][1], sharded_lp)
        np.testing.assert_array_equal(r["sampler"][3], sharded_p)


def test_errors_and_multiprocess_helpers(world):
    """N not divisible by the ranks raises the JAX package's ValueError;
    the 2-D layout asks the mesh for its column axis, which a 1-D mesh
    lacks; initialize_multihost is a no-op in an
    initialized world (and in a single process, here); process_local_batch
    splits by the world."""
    from albatross_tpu_torch.parallel import multihost

    _, results = world
    errors = results[0]["errors"]
    assert errors["cholesky"] == "ValueError: N=30 not divisible by mesh axis size 4"
    assert errors["gram"] == "ValueError: N=30 not divisible by mesh axis size 4"
    assert errors["col_axis"] == "ValueError: mesh has no axis 'model'; its axes are ('data',)"
    assert "spans the whole world" in errors["n_devices"]
    assert errors["batch"] == "ValueError: global batch 98 not divisible by 4 processes"
    assert "no axis 'rows'" in errors["axis"]
    assert results[0]["process_local_batch"] == 24
    assert results[0]["global_mesh"] == (("data",), (4,))
    multihost.initialize_multihost()
    assert not torch.distributed.is_initialized()
    assert multihost.process_local_batch(96) == 96
    with pytest.raises(RuntimeError, match="initialized process group"):
        multihost.global_mesh(device="cpu")


def test_checkpoint_rebinds_the_mesh(world):
    """A distributed fit saved on every rank is saved by its mesh's names
    and shape: it loads onto a fresh mesh over the world or onto a given
    mesh; mismatched axes or grid raise, and so does a process whose
    world does not match (this one, without a process group)."""
    from albatross_tpu_torch.serialize import load_checkpoint

    inputs, results = world
    for r in results:
        ck = r["checkpoint"]
        np.testing.assert_array_equal(ck["default"], ck["before"])
        np.testing.assert_array_equal(ck["2d_default"], ck["2d_before"])
        assert ck["same_mesh"] and ck["fresh_mesh"] == (4,)
        assert "checkpoint mesh axes ('data',) do not match the provided mesh axes ('rows',)" in ck["axes"]
        assert "checkpoint mesh grid (2, 2) does not match the provided mesh grid (4, 1)" in ck["grid"]
    with open(os.path.join(inputs["ckpt_dir"], "dist_1d.ckpt"), "rb") as f:
        f.read(8)
        assert pickle.load(f)["version"] == 2
    with pytest.raises(ValueError, match=r"saved on a \(4,\) device mesh \(4 devices\) but only 1 are visible"):
        load_checkpoint(os.path.join(inputs["ckpt_dir"], "dist_1d.ckpt"), device="cpu")
