"""The rank side of tests/test_torch_parallel.py: one process of a gloo
world, which runs every check of the port's ``parallel`` package on the
inputs the test hands over and writes its results for the test to hold
against the JAX package.  Imports torch and the port, never JAX; holds no
test of its own.
"""

import datetime
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist


def _checks(rank, world, inputs):
    import albatross_tpu_torch as pt
    from albatross_tpu_torch import parallel as par
    from albatross_tpu_torch.evaluation.cross_validation_utils import held_out_predictions
    from albatross_tpu_torch.indexing import KFoldGrouper, LeaveOneOutGrouper, group_by
    from albatross_tpu_torch.kernels.features import Measurement
    from albatross_tpu_torch.parallel import multihost
    from albatross_tpu_torch.samplers import ensemble_sampler_from_model
    from albatross_tpu_torch.serialize import load_checkpoint, save_checkpoint

    out = {}
    mesh = par.make_mesh(device="cpu")
    T = torch.tensor

    def local(dt):
        return dt.to_local().detach().numpy()

    # -- the factorization and its solves --------------------------------
    A = T(inputs["A64"])
    L = par.distributed_cholesky(A, mesh)
    out["chol_local"] = local(L)
    out["chol_placements"] = [p.is_shard(0) for p in L.placements]
    A = T(inputs["A48"])
    L = par.distributed_cholesky(A, mesh)
    out["solve"] = par.distributed_solve(L, T(inputs["rhs48"]), mesh).numpy()
    out["solve_matrix"] = par.distributed_solve(L, T(inputs["RHS48"]), mesh).numpy()
    out["sqrt_solve"] = par.distributed_sqrt_solve(L, T(inputs["rhs48"]), mesh).numpy()
    out["log_det"] = float(par.distributed_log_determinant(L, mesh))
    L = par.distributed_cholesky(T(inputs["A32"]), mesh)
    out["inverse_diagonal"] = par.distributed_inverse_diagonal(L, mesh).numpy()
    out["inverse_blocks"] = [b.numpy() for b in par.distributed_inverse_blocks(L, inputs["groups32"], mesh)]

    # -- grams -------------------------------------------------------------
    x40 = T(inputs["x40"])
    kernel = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2))
    out["gram"] = local(par.sharded_gram(kernel, x40, mesh, measurement=True))
    out["gram_var"] = local(par.sharded_gram(kernel, x40, mesh, measurement=True,
                                             target_variance=torch.full((40,), 0.01, dtype=torch.float64)))
    out["gram_single"] = kernel(Measurement(x40)).numpy()
    out["cross"] = local(par.sharded_cross_gram(kernel, x40, T(inputs["xs5"]), mesh))
    se = pt.SquaredExponential(0.5, 0.1)
    for i, (x, ys) in enumerate(inputs["bitwise"]):
        x, ys = T(x), T(ys)
        out[f"bitwise_gram{i}"] = (local(par.sharded_gram(se, x, mesh)), se(x).numpy())
        out[f"bitwise_cross{i}"] = (local(par.sharded_cross_gram(se, x, ys, mesh)), se.matrix_or_none(x, ys).numpy())
    unique = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2, assume_unique=True))
    xd = T(inputs["x_dup"])
    out["gram_dup"] = local(par.sharded_gram(unique, xd, mesh, measurement=True))
    out["gram_dup_single"] = unique(Measurement(xd)).numpy()

    # -- the distributed GP ------------------------------------------------
    x, y = inputs["gp"]
    data = pt.RegressionDataset.create(T(x), T(y), variance=torch.full((len(x),), 0.01, dtype=torch.float64))
    single = pt.gp_from_covariance(kernel)
    multi = par.distributed_gp_from_covariance(kernel, mesh)
    xs = T(inputs["xs8"])
    for name, model in (("multi", multi), ("single", single)):
        p = model.fit(data).predict(xs).marginal()
        out[f"gp_{name}"] = (p.mean.numpy(), p.variance.numpy(), float(model.log_likelihood(data)))

    x, y = inputs["grad"]
    data = pt.RegressionDataset.create(T(x), T(y))
    gk = pt.SquaredExponential(2.0, 1.0) + pt.IndependentNoise(0.1)
    for name, model in (("multi", par.distributed_gp_from_covariance(gk, mesh)), ("single", pt.gp_from_covariance(gk))):
        v = model.get_tunable_parameters().values.clone().requires_grad_(True)
        value = -model.set_tunable_params(v).log_likelihood(data)
        (g,) = torch.autograd.grad(value, v)
        out[f"grad_{name}"] = (value.item(), g.numpy())

    # -- fast cross-validation, update ---------------------------------------
    x, y = inputs["cv"]
    data = pt.RegressionDataset.create(T(x), T(y), variance=torch.full((len(x),), 0.01, dtype=torch.float64))
    for name, model in (("multi", multi), ("single", single)):
        fit = model.fit(data).fit
        loo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information,
                                   group_by(data, LeaveOneOutGrouper()).indexers(), None)
        logo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information,
                                    group_by(data, KFoldGrouper(4)).indexers(), pt.JointDistribution)
        out[f"loo_{name}"] = {k: loo[k].numpy() for k in loo}
        out[f"logo_{name}"] = {k: (logo[k].mean.numpy(), logo[k].covariance.numpy()) for k in logo}

    (x1, y1), (x2, y2), xs40 = inputs["update"]
    var = lambda n: torch.full((n,), 0.01, dtype=torch.float64)  # noqa: E731
    d1 = pt.RegressionDataset.create(T(x1), T(y1), variance=var(len(x1)))
    d2 = pt.RegressionDataset.create(T(x2), T(y2), variance=var(len(x2)))
    uk = pt.SquaredExponential(1.5, 1.0) + pt.IndependentNoise(0.1)
    updated = par.distributed_gp_from_covariance(uk, mesh).fit(d1).update(d2)
    p = updated.predict(T(xs40)).marginal()
    out["update"] = (p.mean.numpy(), p.variance.numpy())
    dall = pt.RegressionDataset.create(T(np.concatenate([x1, x2])), T(np.concatenate([y1, y2])),
                                       variance=var(len(x1) + len(x2)))
    p = pt.gp_from_covariance(uk).fit(dall).predict(T(xs40)).marginal()
    out["refit"] = (p.mean.numpy(), p.variance.numpy())
    d3 = pt.RegressionDataset.create(T(xs40[:8]), T(np.sin(xs40[:8])), variance=var(8))
    out["update_twice_finite"] = bool(torch.isfinite(updated.update(d3).predict(T(xs40)).marginal().mean).all())

    # -- the walker-sharded sampler ------------------------------------------
    x = inputs["sampler"]
    data = pt.RegressionDataset.create(T(x), T(np.sin(x)))
    sm = pt.gp_from_covariance(pt.SquaredExponential(2.0, 1.0) + pt.IndependentNoise(0.2))
    kwargs = dict(n_walkers=16, max_iterations=8, key=7)
    plain = ensemble_sampler_from_model(sm, data, **kwargs)
    sharded = ensemble_sampler_from_model(sm, data, mesh=mesh, mesh_axis="data", **kwargs)
    out["sampler"] = (plain.log_prob, sharded.log_prob, plain.params, sharded.params)

    # -- errors and the multi-process helpers --------------------------------
    errors = {}
    for name, fn in (
        ("cholesky", lambda: par.distributed_cholesky(T(inputs["A30"]), mesh)),
        ("gram", lambda: par.sharded_gram(kernel, T(inputs["A30"][0]), mesh)),
        ("col_axis", lambda: par.DistributedGaussianProcess(kernel, mesh, col_axis="model").fit(data)),
        ("n_devices", lambda: par.make_mesh(2, device="cpu")),
        ("batch", lambda: multihost.process_local_batch(98)),
        ("axis", lambda: par.sharded_gram(kernel, x40, mesh, axis="rows")),
    ):
        try:
            fn()
            errors[name] = None
        except (ValueError, NotImplementedError) as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    multihost.initialize_multihost()  # already initialized: a no-op
    out["process_local_batch"] = multihost.process_local_batch(96)
    out["global_mesh"] = (multihost.global_mesh(device="cpu").mesh_dim_names, tuple(mesh.shape))

    # -- checkpoints: the mesh saved by its signature, rebound at load -------
    fit_model = multi.fit(data_gp := pt.RegressionDataset.create(
        T(inputs["gp"][0]), T(inputs["gp"][1]), variance=torch.full((len(inputs["gp"][0]),), 0.01,
                                                                       dtype=torch.float64)))
    before = fit_model.predict(xs).marginal().mean.numpy()
    path = inputs["ckpt_dir"] + "/dist_1d.ckpt"
    save_checkpoint(path, fit_model)
    dist.barrier()
    restored = load_checkpoint(path, device="cpu")
    rebound = load_checkpoint(path, device="cpu", mesh=mesh)
    ck = {
        "default": restored.predict(xs).marginal().mean.numpy(),
        "before": before,
        "same_mesh": rebound.fit.train_covariance.mesh is mesh and rebound.model.mesh is mesh,
        "fresh_mesh": tuple(restored.fit.train_covariance.mesh.shape),
    }
    bad = par.make_mesh(axis_names=("rows",), device="cpu")
    for name, m in (("axes", bad),):
        try:
            load_checkpoint(path, device="cpu", mesh=m)
            ck[name] = None
        except ValueError as e:
            ck[name] = str(e)
    mesh2d = par.make_mesh(axis_names=("data", "model"), shape=(2, 2), device="cpu")
    fit2d = par.DistributedGaussianProcess(kernel, mesh2d, axis="data").fit(data_gp)
    ck["2d_before"] = fit2d.predict(xs).marginal().mean.numpy()
    path2d = inputs["ckpt_dir"] + "/dist_2d.ckpt"
    save_checkpoint(path2d, fit2d)
    dist.barrier()
    ck["2d_default"] = load_checkpoint(path2d, device="cpu").predict(xs).marginal().mean.numpy()
    try:
        load_checkpoint(path2d, device="cpu",
                        mesh=par.make_mesh(axis_names=("data", "model"), shape=(4, 1), device="cpu"))
        ck["grid"] = None
    except ValueError as e:
        ck["grid"] = str(e)
    out["checkpoint"] = ck
    return out


def run(rank, world, init_file, out_dir, inputs, checks=None):
    """Join the gloo world, run every check (``checks``, this module's by
    default) on the inputs pickled at the path ``inputs``, write
    ``rank<r>.pkl``: the results, or the traceback of the first failure.
    (Inputs passed through a file keep the spawn pipe small: a payload
    larger than the pipe's buffer makes each ``Process.start`` wait for the
    child to import torch.)"""
    with open(inputs, "rb") as f:
        inputs = pickle.load(f)
    torch.set_num_threads(1)
    torch.exp(torch.linspace(-3.0, 0.0, 4096, dtype=torch.float32))  # warm up the f32 exp
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        result = {"ok": True, "out": (checks or _checks)(rank, world, inputs)}
    except Exception:  # report it to the test, which fails with the traceback
        result = {"ok": False, "error": traceback.format_exc()}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()
