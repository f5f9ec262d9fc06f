"""Mesh-distributed exact and sparse GPs through the port.

    python -m albatross_tpu_torch.examples.distributed [--n 512] [--ranks 8] [--device cpu]

Shown beside the single-process model, as the JAX package's
``examples/distributed.py`` shows them beside the single chip:

  * the exact GP, 1-D row layout (N^2 / R entries a rank);
  * the exact GP, 2-D tile layout (N^2 / (R C) a rank) and fast LOO;
  * the online update on the distributed fit against the refit;
  * the sparse GP (FITC) with sharded K_fu rows and a TSQR.

Every rank runs the same code on the same data over a ("data", "model")
mesh of shape (ranks / 2, 2) ((4, 2) for 8 ranks).  Started outside a
process group (no ``WORLD_SIZE`` in the environment, as under
``torchrun``), the example spawns ``--ranks`` processes that form a gloo
world through a file rendezvous; on the card they share it (NCCL refuses
two ranks on one GPU).  Under ``torchrun`` it joins the world it is given
(NCCL on the card, each rank on its ``LOCAL_RANK``'s GPU).  It exits 1 when
a distributed result differs from the single process's by more than 1e-6
relative, as the JAX example does.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import pickle
import sys
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .. import _build, config
from ..core import RegressionDataset
from ..kernels import IndependentNoise, SquaredExponential
from ..models import UniformlySpacedInducingPoints, gp_from_covariance, sparse_gp_from_covariance
from ..parallel import distributed_gp_from_covariance, distributed_sparse_gp_from_covariance, make_mesh

TOLERANCE = 1e-6
RANK_TIMEOUT_S = 600


def mesh_shape(ranks: int) -> tuple:
    """The ("data", "model") mesh over ``ranks``: (ranks / 2, 2), or
    (ranks, 1) for an odd count."""
    return (ranks // 2, 2) if ranks % 2 == 0 else (ranks, 1)


def _max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.max(torch.abs(a - b)))


def run_in_world(n: int, device=None, dtype=torch.float64) -> dict:
    """The example on the calling rank of an initialized process group:
    every number it prints, with ``ok`` (each distributed NLML within
    TOLERANCE of the single process's) and ``tile`` (this rank's factor
    tile)."""
    dev = config.device(device)
    mesh = make_mesh(axis_names=("data", "model"), shape=mesh_shape(dist.get_world_size()), device=dev)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.sort(rng.uniform(0.0, 10.0, n)))
    y = torch.sin(x) + 0.1 * torch.as_tensor(rng.standard_normal(n))

    def dataset(rows: slice) -> RegressionDataset:
        count = x[rows].shape[0]
        return RegressionDataset.create(x[rows], y[rows], variance=np.full((count,), 0.01), device=dev, dtype=dtype)

    data = dataset(slice(None))
    kernel = SquaredExponential(1.5, 1.0) + IndependentNoise(0.1)
    xs = torch.as_tensor(np.linspace(0.0, 10.0, 64), device=dev, dtype=dtype)
    out = {}

    single = gp_from_covariance(kernel)
    out["single_nlml"] = float(-single.log_likelihood(data))
    ref_mean = single.fit(data).predict(xs).marginal().mean

    # the exact GP, 1-D row panels
    gp1 = distributed_gp_from_covariance(kernel, mesh, axis="data")
    out["nlml_1d"] = float(-gp1.log_likelihood(data))
    out["mean_err_1d"] = _max_diff(gp1.fit(data).predict(xs).marginal().mean, ref_mean)

    # the exact GP, 2-D tiles, and fast LOO
    gp2 = distributed_gp_from_covariance(kernel, mesh, axis="data", col_axis="model", panel=min(128, n // 8))
    out["nlml_2d"] = float(-gp2.log_likelihood(data))
    fit2 = gp2.fit(data)
    out["mean_err_2d"] = _max_diff(fit2.predict(xs).marginal().mean, ref_mean)
    out["loo_var0"] = float(1.0 / fit2.fit.train_covariance.inverse_diagonal()[0])
    out["tile"] = tuple(fit2.fit.train_covariance.L.to_local().shape)
    del fit2

    # the online update against the refit
    half = n // 2
    updated = gp1.fit(dataset(slice(None, half))).update(dataset(slice(half, None)))
    out["update_err"] = _max_diff(updated.predict(xs).marginal().mean, ref_mean)

    # the sparse GP (FITC): sharded K_fu rows and a TSQR
    strategy = UniformlySpacedInducingPoints(24)
    sp_single = sparse_gp_from_covariance(kernel, inducing_point_strategy=strategy)
    sp_dist = distributed_sparse_gp_from_covariance(kernel, mesh, axis="data", inducing_point_strategy=strategy)
    out["sparse_single_ll"] = float(sp_single.log_likelihood(data))
    out["sparse_ll"] = float(sp_dist.log_likelihood(data))
    out["sparse_mean_err"] = _max_diff(sp_dist.fit(data).predict(xs).marginal().mean,
                                       sp_single.fit(data).predict(xs).marginal().mean)

    def close(got, ref):
        return abs(got - ref) < TOLERANCE * abs(ref)

    out["ok"] = (close(out["nlml_1d"], out["single_nlml"]) and close(out["nlml_2d"], out["single_nlml"])
                 and close(out["sparse_ll"], out["sparse_single_ll"]))
    return out


def _rank(rank: int, world: int, root: str, n: int, device: str, dtype: torch.dtype) -> None:
    """One spawned rank: join the gloo world, run the example, write
    ``rank<r>.pkl`` (its result and launch counts, or its traceback)."""
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    else:
        torch.cuda.set_device(torch.device(device).index or 0)
    torch.exp(torch.linspace(-3.0, 0.0, 4096, dtype=torch.float32))  # warm up the f32 exp
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    try:
        result = {"ok": True, "out": run_in_world(n, device, dtype), "launches": dict(_build.LAUNCHES)}
    except Exception:  # the parent raises it
        result = {"ok": False, "error": traceback.format_exc()}
    with open(f"{root}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def spawn_world(ranks: int, n: int, device: str, dtype: torch.dtype) -> list:
    """Run the example on a spawned gloo world of ``ranks`` processes and
    return each rank's result; a rank that fails raises here with its
    traceback, a rank still running after RANK_TIMEOUT_S is killed."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as root:
        procs = [ctx.Process(target=_rank, args=(r, ranks, root, n, device, dtype)) for r in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=RANK_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if hung:
            raise RuntimeError(f"ranks {hung} still running after {RANK_TIMEOUT_S} s")
        results = []
        for r, p in enumerate(procs):
            path = f"{root}/rank{r}.pkl"
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} wrote no result (exit code {p.exitcode})")
            with open(path, "rb") as f:
                result = pickle.load(f)
            if not result["ok"]:
                raise RuntimeError(f"rank {r} failed:\n{result['error']}")
            results.append(result)
    return results


def run(n: int = 512, ranks: int = 8, device=None, dtype=torch.float64) -> dict:
    """Rank 0's numbers (``run_in_world``), with every rank's ``tiles``
    and the ranks' summed kernel ``launches``: in the calling process's
    world if it has one (or ``torchrun``'s), else on a spawned gloo world
    of ``ranks`` processes."""
    dev = config.device(device)
    if dist.is_initialized():
        return run_in_world(n, dev, dtype)
    if "WORLD_SIZE" in os.environ:  # torchrun: join its world, one GPU a rank on the card
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("gloo" if dev.type == "cpu" else "nccl")
        try:
            return run_in_world(n, dev, dtype)
        finally:
            dist.destroy_process_group()
    results = spawn_world(ranks, n, str(dev), dtype)
    out = dict(results[0]["out"])
    out["tiles"] = [r["out"]["tile"] for r in results]
    out["launches"] = {name: sum(r["launches"][name] for r in results) for name in results[0]["launches"]}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--ranks", type=int, default=8,
                        help="processes of the spawned gloo world (ignored inside a process group)")
    parser.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = parser.parse_args(argv)
    n = args.n

    out = run(n, args.ranks, args.device)
    print(f"single-chip      NLML = {out['single_nlml']:.6f}")
    print(f"1-D row-sharded  NLML = {out['nlml_1d']:.6f}  max|Δmean| = {out['mean_err_1d']:.2e}")
    print(f"2-D tile-sharded NLML = {out['nlml_2d']:.6f}  max|Δmean| = {out['mean_err_2d']:.2e}  "
          f"LOO var[0] = {out['loo_var0']:.4f}")
    print(f"  per-device factor tile: {out['tile']} of ({n}, {n})")
    print(f"update==refit    max|Δmean| = {out['update_err']:.2e}")
    print(f"sparse (TSQR)    NLML = {out['sparse_ll']:.6f} (single {out['sparse_single_ll']:.6f})  "
          f"max|Δmean| = {out['sparse_mean_err']:.2e}")
    print("all distributed paths match single-chip" if out["ok"] else "MISMATCH")
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
