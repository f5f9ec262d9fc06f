"""Where the sparse GP's f32 fit loses accuracy on one GPU.

    python -m albatross_tpu_torch.sparse_precision [--parts stages qr] [--sizes 8192:1024:0.2 ...]

The data are ``chip_smoke.py``'s FITC data (N sorted f32 inputs on
[0, 100], targets sin(0.3 x) + 0.1 noise, numpy seed 4), the model
SquaredExponential(l, 1.0) + measurement_only(IndependentNoise(0.3)) as
FITC on M uniformly spaced inducing points, each size given as N:M:l
(the defaults put the points 100 / (M - 1) ~ l / 2 apart).

"stages" runs the fit and a marginal prediction at 1024 points on the card
and on the CPU, each in f32 and f64, and prints the largest difference over
the largest entry, between each pair of runs, of each stage: the inducing
points u, K_fu, K_uu's factor, A's diagonal, B = [A^-1/2 K_fu; L_uu^T],
|diag R| of B's QR, v and the predictions.  "qr" takes the f32 B on the
card and prints |diag R| and v against the f64 data's for cuSOLVER's f32
QR, an f64 QR of the same f32 B (the route ``models/sparse_gp.py``
takes), a two-level row-blocked QR, and the CPU's f32 QR, with the card's
times.  Each line carries the card's name and power limit as nvidia-smi
gives them.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

DEFAULT_SIZES = ("8192:1024:0.2", "32768:1024:0.2", "131072:4096:0.05")


def _problem(pt, n: int, m: int, length_scale: float):
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
    y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    kernel = pt.SquaredExponential(length_scale, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.sparse_gp_from_covariance(kernel, inducing_point_strategy=pt.UniformlySpacedInducingPoints(m))
    return model, x, y


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def _augmented(model, data):
    """(u, B, the whitened targets [A^-1/2 y; 0], K_uu's factor, A, K_fu)."""
    u = model.inducing_point_strategy(model.covariance_function, data.features)
    A_chol, K_uu_chol, K_fu, y = model._compute_internal_components(u, data.features, data.targets)
    B = model._augmented(A_chol, K_uu_chol, K_fu)
    y_aug = A_chol.sqrt_solve(y)
    y_aug = torch.cat([y_aug, y_aug.new_zeros(B.shape[1])])
    return u, B, y_aug, K_uu_chol, A_chol, K_fu


def _stages(pt, card: str, n: int, m: int, length_scale: float) -> None:
    from .models.sparse_gp import _qr_r_and_v

    model, x, y = _problem(pt, n, m, length_scale)
    xs = np.linspace(0.0, 100.0, 1024).astype(np.float32)
    runs = {}
    for dev in ("cuda", "cpu"):
        for dtype in (torch.float32, torch.float64):
            data = pt.RegressionDataset.create(x, y, device=dev, dtype=dtype)
            u, B, y_aug, K_uu_chol, A_chol, K_fu = _augmented(model, data)
            R, v, _ = _qr_r_and_v(B, y_aug)
            pred = model.fit(data).predict(torch.as_tensor(xs, device=dev, dtype=dtype)).marginal()
            runs[dev, dtype] = {"u": u, "K_fu": K_fu[:4096], "L_uu": K_uu_chol.L, "A": A_chol.sqrt_diag,
                                "B": B[:4096], "|diag R|": torch.diagonal(R).abs(), "v": v, "mean": pred.mean,
                                "variance": pred.variance}
            del u, B, y_aug, K_uu_chol, A_chol, K_fu, R, v, pred
    f32, f64 = torch.float32, torch.float64
    pairs = {"card f32 vs card f64": (("cuda", f32), ("cuda", f64)), "cpu f32 vs cpu f64": (("cpu", f32), ("cpu", f64)),
             "card f32 vs cpu f32": (("cuda", f32), ("cpu", f32)), "card f64 vs cpu f64": (("cuda", f64), ("cpu", f64))}
    for name, (a, b) in pairs.items():
        print(f"[{card}] stages N={n} M={m} {name}: "
              + ", ".join(f"{k} {_rel(runs[a][k], runs[b][k]):.3e}" for k in runs[a]), flush=True)


def _qr(pt, card: str, n: int, m: int, length_scale: float) -> None:
    model, x, y = _problem(pt, n, m, length_scale)
    with torch.no_grad():
        B32, y32 = _augmented(model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float32))[1:3]
        B64, y64 = _augmented(model, pt.RegressionDataset.create(x, y, device="cuda", dtype=torch.float64))[1:3]

        def r_and_v(B, y):
            Q, R = torch.linalg.qr(B, mode="reduced")
            return R, torch.linalg.solve_triangular(R, (Q.T @ y)[:, None], upper=True)[:, 0]

        def blocked(B, y, rows):
            Rs, zs = [], []
            for s in range(0, B.shape[0], rows):
                Q, R = torch.linalg.qr(B[s:s + rows], mode="reduced")
                Rs.append(R)
                zs.append(Q.T @ y[s:s + rows])
            Q, R = torch.linalg.qr(torch.cat(Rs), mode="reduced")
            return R, torch.linalg.solve_triangular(R, (Q.T @ torch.cat(zs))[:, None], upper=True)[:, 0]

        R64, v64 = r_and_v(B64, y64)
        variants = {"cuSOLVER f32": lambda: r_and_v(B32, y32),
                    "f64 QR of the f32 B": lambda: r_and_v(B32.double(), y32.double()),
                    "two-level QR, blocks of 8192 rows": lambda: blocked(B32, y32, 8192)}
        if n <= 32768:
            variants["CPU f32"] = lambda: r_and_v(B32.cpu(), y32.cpu())
        for name, fn in variants.items():
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            R, v = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            print(f"[{card}] tall QR N={n} M={m} ({B32.shape[0]} x {m}) {name}: |diag R| "
                  f"{_rel(torch.diagonal(R).abs(), torch.diagonal(R64).abs()):.3e}, v {_rel(v, v64):.3e}, "
                  f"{seconds:.4f} s", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parts", nargs="+", default=["stages", "qr"], choices=["stages", "qr"])
    parser.add_argument("--sizes", nargs="+", default=list(DEFAULT_SIZES), help="N:M:l triples")
    args = parser.parse_args()

    import albatross_tpu_torch as pt

    if not torch.cuda.is_available():
        raise SystemExit("sparse_precision needs a GPU: torch.cuda.is_available() is False")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; {card}", flush=True)
    for size in args.sizes:
        n, m, length_scale = size.split(":")
        for part in args.parts:
            (_stages if part == "stages" else _qr)(pt, card, int(n), int(m), float(length_scale))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
