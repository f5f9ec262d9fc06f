"""The rank side of tests/test_torch_parallel_2d.py: one process of a gloo
world of 8, which runs every check of the port's 2-D tile layout (on a
(4, 2) mesh) and distributed sparse GP (on the 1-D mesh of 8) on the
inputs the test hands over and writes its results for the test to hold
against the JAX package.  Imports torch and the port, never JAX; holds no
test of its own.
"""

import numpy as np
import torch
import torch.distributed as dist

import test_torch_parallel_ranks


class _LargestOutput(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the largest number of entries any op writes into new
    memory (a view of an input, or an op's in-place result, is none)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        inputs = {t.untyped_storage().data_ptr() for t in torch.utils._pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in inputs:
                self.largest = max(self.largest, t.numel())
        return out


def _checks(rank, world, inputs):
    import albatross_tpu_torch as pt
    from albatross_tpu_torch import parallel as par
    from albatross_tpu_torch.evaluation.cross_validation_utils import held_out_predictions
    from albatross_tpu_torch.indexing import KFoldGrouper, LeaveOneOutGrouper, group_by
    from albatross_tpu_torch.kernels.features import Measurement
    from albatross_tpu_torch.models.sparse_gp import UniformlySpacedInducingPoints, sparse_gp_from_covariance
    from albatross_tpu_torch.parallel import cholesky2d as c2d
    from albatross_tpu_torch.serialize import load_checkpoint, save_checkpoint

    out = {}
    mesh2d = par.make_mesh(axis_names=("data", "model"), shape=(4, 2), device="cpu")
    mesh = par.make_mesh(device="cpu")
    T = torch.tensor

    def local(dt):
        return dt.to_local().detach().numpy()

    var = lambda n: torch.full((n,), 0.01, dtype=torch.float64)  # noqa: E731
    kernel = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2))

    # -- the 2-D gram --------------------------------------------------------
    x40 = T(inputs["x40"])
    K = par.sharded_gram_2d(kernel, x40, mesh2d, measurement=True, target_variance=var(40))
    out["gram2d"] = local(K)
    out["gram2d_placements"] = [str(p) for p in K.placements]
    out["gram2d_single"] = (kernel(Measurement(x40)) + 0.01 * torch.eye(40, dtype=torch.float64)).numpy()
    unique = pt.SquaredExponential(1.5, 1.0) + pt.measurement_only(pt.IndependentNoise(0.2, assume_unique=True))
    xd = T(inputs["x_dup"])
    out["gram2d_dup"] = local(par.sharded_gram_2d(unique, xd, mesh2d, measurement=True))
    out["gram2d_dup_single"] = unique(Measurement(xd)).numpy()

    # -- the factorization, its solves and inverse pieces ----------------------
    A = T(inputs["A64"])
    L = par.distributed_cholesky_2d(A, mesh2d)
    out["chol2d"] = local(L)
    out["chol2d_from_tiles"] = local(par.distributed_cholesky_2d(par.sharded_gram_2d(
        pt.SquaredExponential(1.0, 1.0) + pt.IndependentNoise(1.0), T(inputs["x64"]), mesh2d), mesh2d, panel=8))
    RHS = T(inputs["RHS64"])
    out["solve2d"] = par.distributed_solve_2d(L, RHS[:, :3], mesh2d).numpy()
    out["sqrt_solve2d"] = par.distributed_sqrt_solve_2d(L, RHS[:, 0], mesh2d).numpy()
    out["log_det2d"] = float(par.distributed_log_determinant_2d(L, mesh2d))
    out["inverse_diagonal2d"] = par.distributed_inverse_diagonal_2d(L, mesh2d).numpy()
    out["inverse_blocks2d"] = [b.numpy() for b in par.distributed_inverse_blocks_2d(L, inputs["groups64"], mesh2d)]
    out["tri_inverse2d"] = local(par.distributed_tri_inverse_2d(L, mesh2d))
    for mode in ("inverse", "substitution", "auto"):
        out[f"wsolve_{mode}"] = (par.distributed_sqrt_solve_2d(L, RHS, mesh2d, mode=mode).numpy(),
                                 par.distributed_solve_2d(L, RHS, mesh2d, mode=mode).numpy())
    out["wsolve_vector"] = par.distributed_solve_2d(L, RHS[:, 5], mesh2d, mode="auto").numpy()

    # auto takes the inverse route for W_SOLVE_MIN_RHS right-hand sides
    def boom(*a, **k):
        raise AssertionError("substitution path used for wide RHS")

    saved = c2d._forward_sub_2d, c2d._back_sub_2d
    c2d._forward_sub_2d = c2d._back_sub_2d = boom
    try:
        out["auto_wide"] = par.distributed_solve_2d(L, RHS[:, :c2d.W_SOLVE_MIN_RHS], mesh2d, mode="auto").numpy()
    finally:
        c2d._forward_sub_2d, c2d._back_sub_2d = saved

    # the collectives each route runs, counted at two sizes
    counted = dist.all_reduce
    calls = [0]

    def counting(*a, **k):
        calls[0] += 1
        return counted(*a, **k)

    rounds = {}
    for n in (64, 192):
        Ln = L if n == 64 else par.distributed_cholesky_2d(T(inputs["A192"]), mesh2d)
        rhs33 = T(inputs[f"RHS{n}_33"])
        for mode in ("inverse", "substitution"):
            dist.all_reduce = counting
            calls[0] = 0
            try:
                par.distributed_solve_2d(Ln, rhs33, mesh2d, mode=mode)
            finally:
                dist.all_reduce = counted
            rounds[mode, n] = calls[0]
    out["rounds"] = rounds

    # no rank writes an N x N tensor; the factorization's largest
    # transient shrinks with the panel width
    A256 = T(inputs["A256"])
    largest = {}
    for p in (128, 32):
        with _LargestOutput() as rec:
            L256 = par.distributed_cholesky_2d(A256, mesh2d, panel=p)
        largest[p] = rec.largest
    with _LargestOutput() as rec:
        par.distributed_inverse_diagonal_2d(L256, mesh2d)
    largest["inverse_diagonal"] = rec.largest
    largest["tile"] = tuple(L256.to_local().shape)
    out["largest"] = largest

    # -- the 2-D distributed GP ----------------------------------------------
    x, y = inputs["gp"]
    data = pt.RegressionDataset.create(T(x), T(y), variance=var(len(x)))
    single = pt.gp_from_covariance(kernel)
    multi = par.distributed_gp_from_covariance(kernel, mesh2d, col_axis="model")
    xs = T(inputs["xs8"])
    for name, model in (("multi", multi), ("single", single)):
        p = model.fit(data).predict(xs).marginal()
        out[f"gp_{name}"] = (p.mean.numpy(), p.variance.numpy(), float(model.log_likelihood(data)))
        fit = model.fit(data).fit
        loo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information,
                                   group_by(data, LeaveOneOutGrouper()).indexers(), None)
        logo = held_out_predictions(fit.train_covariance, data.targets.mean, fit.information,
                                    group_by(data, KFoldGrouper(4)).indexers(), pt.JointDistribution)
        out[f"loo_{name}"] = {k: loo[k].numpy() for k in loo}
        out[f"logo_{name}"] = {k: (logo[k].mean.numpy(), logo[k].covariance.numpy()) for k in logo}

    x, y = inputs["grad"]
    gdata = pt.RegressionDataset.create(T(x), T(y))
    gk = pt.SquaredExponential(2.0, 1.0) + pt.IndependentNoise(0.1)
    for name, model in (("multi", par.distributed_gp_from_covariance(gk, mesh2d, col_axis="model")),
                        ("single", pt.gp_from_covariance(gk))):
        v = model.get_tunable_parameters().values.clone().requires_grad_(True)
        value = -model.set_tunable_params(v).log_likelihood(gdata)
        (g,) = torch.autograd.grad(value, v)
        out[f"grad_{name}"] = (value.item(), g.numpy())

    (x1, y1), (x2, y2), xs40 = inputs["update"]
    d1 = pt.RegressionDataset.create(T(x1), T(y1), variance=var(len(x1)))
    d2 = pt.RegressionDataset.create(T(x2), T(y2), variance=var(len(x2)))
    uk = pt.SquaredExponential(1.5, 1.0) + pt.IndependentNoise(0.1)
    dall = pt.RegressionDataset.create(T(np.concatenate([x1, x2])), T(np.concatenate([y1, y2])),
                                       variance=var(len(x1) + len(x2)))
    p = pt.gp_from_covariance(uk).fit(dall).predict(T(xs40)).marginal()
    out["refit"] = (p.mean.numpy(), p.variance.numpy())
    d3 = pt.RegressionDataset.create(T(xs40[:8]), T(np.sin(xs40[:8])), variance=var(8))
    for layout, kw in (("1d", {}), ("2d", {"col_axis": "model"})):
        updated = par.DistributedGaussianProcess(uk, mesh2d, axis="data", **kw).fit(d1).update(d2)
        p = updated.predict(T(xs40)).marginal()
        twice = updated.update(d3).predict(T(xs40)).marginal().mean
        out[f"update_{layout}"] = (p.mean.numpy(), p.variance.numpy(), bool(torch.isfinite(twice).all()))

    # a 2-D fit saved on every rank loads back with its tiles
    fit2d = multi.fit(data)
    path = inputs["ckpt_dir"] + "/dist_2d_tiles.ckpt"
    save_checkpoint(path, fit2d)
    dist.barrier()
    restored = load_checkpoint(path, device="cpu")
    out["checkpoint"] = (fit2d.predict(xs).marginal().mean.numpy(), restored.predict(xs).marginal().mean.numpy(),
                         [str(p) for p in restored.fit.train_covariance.L.placements])

    # -- the TSQR and the distributed sparse GP (1-D mesh of 8) ---------------
    B, extra = T(inputs["B128"]), T(inputs["extra12"])
    out["tsqr"] = par.distributed_tall_qr(B, mesh, "data", extra=extra).numpy()
    out["tsqr_sharded"] = par.distributed_tall_qr(
        par.sharded_cross_gram(pt.SquaredExponential(2.0, 1.0), T(inputs["x_sparse"][:128]),
                               torch.linspace(0, 10, 12, dtype=torch.float64), mesh), mesh).numpy()
    x, y = inputs["sparse"]
    sdata = pt.RegressionDataset.create(T(x), T(y), variance=var(len(x)))
    sk = pt.SquaredExponential(1.5, 1.0) + pt.IndependentNoise(0.1)
    xs = T(inputs["xs_sparse"])
    for name, size in (("fitc", None), ("pitc32", 32), ("pitc24", 24)):
        kw = dict(inducing_point_strategy=UniformlySpacedInducingPoints(24))
        if size is not None:
            kw["grouper"] = lambda features, size=size: np.arange(len(features)) // size
        for which, model in (("single", sparse_gp_from_covariance(sk, **kw)),
                             ("multi", par.distributed_sparse_gp_from_covariance(sk, mesh, **kw))):
            fit = model.fit(sdata)
            p = fit.predict(xs).marginal()
            v = model.get_tunable_parameters().values.clone().requires_grad_(True)
            value = -model.set_tunable_params(v).log_likelihood(sdata)
            (g,) = torch.autograd.grad(value, v)
            out[f"sparse_{name}_{which}"] = (p.mean.numpy(), p.variance.numpy(), value.item(), g.numpy(),
                                             fit.fit.R.numpy())
    first = pt.RegressionDataset.create(T(x[:128]), T(y[:128]), variance=var(128))
    rest = pt.RegressionDataset.create(T(x[128:]), T(y[128:]), variance=var(128))
    inducing = UniformlySpacedInducingPoints(16)
    out["sparse_update"] = [
        model.fit(first).update(rest).predict(xs).marginal().mean.numpy()
        for model in (par.distributed_sparse_gp_from_covariance(sk, mesh, inducing_point_strategy=inducing),
                      sparse_gp_from_covariance(sk, inducing_point_strategy=inducing))]
    out["kfu_local"] = tuple(par.sharded_cross_gram(sk, T(inputs["x_sparse"]), torch.linspace(0, 10, 16),
                                                    mesh).to_local().shape)

    # -- errors ----------------------------------------------------------------
    errors = {}
    for name, fn in (
        ("cholesky2d", lambda: par.distributed_cholesky_2d(T(inputs["A30"]), mesh2d)),
        ("gram2d", lambda: par.sharded_gram_2d(kernel, T(inputs["A30"][0]), mesh2d)),
        ("panel", lambda: par.distributed_cholesky_2d(A, mesh2d, panel=24)),
        ("tri_inverse2d", lambda: par.distributed_tri_inverse_2d(T(inputs["A30"]), mesh2d)),
        ("tsqr_divisible", lambda: par.distributed_tall_qr(B[:100], mesh)),
        ("tsqr_rows", lambda: par.distributed_tall_qr(B[:16], mesh)),
        ("mode", lambda: par.distributed_solve_2d(L, RHS, mesh2d, mode="lu")),
    ):
        try:
            fn()
            errors[name] = None
        except ValueError as e:
            errors[name] = f"{type(e).__name__}: {e}"
    out["errors"] = errors
    return out


def run(rank, world, init_file, out_dir, inputs):
    """Join the gloo world and run this module's checks (the runner of
    tests/test_torch_parallel_ranks.py)."""
    test_torch_parallel_ranks.run(rank, world, init_file, out_dir, inputs, checks=_checks)
