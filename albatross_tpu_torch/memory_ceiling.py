"""Peak device memory of the NLML and its value+grad on one GPU, by N.

    python -m albatross_tpu_torch.memory_ceiling [--n N ...] [--paths materialized lazy]

For each N and each path it runs one forward ``log_likelihood`` and one
value+grad (-log_likelihood and its gradient with respect to the tunable
vector) of the bench model -- SquaredExponential(0.5, 1.0) +
measurement_only(IndependentNoise(0.3)), jitter 1e-4, N sorted 1-D f32
inputs on [0, 100] -- and prints each call's wall seconds and
``torch.cuda.max_memory_allocated``, or that it ran out of device memory.
"materialized" forces the materialized training covariance
(``CHOLESKY_ALGORITHM = "right"`` with the upgrade off), "lazy" the
lazy-gram loop (``"right_fused"``).  The last line is a JSON list of the
readings, with the card's name and power limit as nvidia-smi gives them.

This is the probe behind ``config.CHOLESKY_FUSED_MIN_N``: it catches
out-of-memory errors, which ``chip_smoke.py`` never does.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import time

DEFAULT_N = (28672, 32768, 40960, 49152, 57344)


def _reading(torch, fn) -> dict:
    """Seconds and peak device memory of one synchronised call of ``fn``,
    or the out-of-memory message."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        fn()
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as err:
        message = str(err).splitlines()[0]
        out = {"oom": message}
    else:
        out = {"seconds": time.perf_counter() - t}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, nargs="+", default=list(DEFAULT_N))
    parser.add_argument("--paths", nargs="+", default=["materialized", "lazy"],
                        choices=["materialized", "lazy"])
    args = parser.parse_args()

    import numpy as np
    import torch

    import albatross_tpu_torch as pt
    from albatross_tpu_torch import _build, config

    if not torch.cuda.is_available():
        raise SystemExit("memory_ceiling: torch.cuda.is_available() is False")
    _build.load_all()  # build the kernels before the first timed call
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    kernel = pt.SquaredExponential(0.5, 1.0) + pt.measurement_only(
        pt.IndependentNoise(0.3, assume_unique=True))
    model = pt.gp_from_covariance(kernel, jitter=1e-4)

    def forward(data):
        model.log_likelihood(data).item()

    def value_grad(data):
        x = model.get_tunable_parameters().values.clone().requires_grad_(True)
        value = -model.set_tunable_params(x).log_likelihood(data)
        torch.autograd.grad(value, x)

    readings = []
    for n in args.n:
        rng = np.random.default_rng(0)
        x = np.sort(rng.uniform(0.0, 100.0, n)).astype(np.float32)
        y = (np.sin(0.3 * x) + 0.1 * rng.standard_normal(n)).astype(np.float32)
        data = pt.RegressionDataset.create(x, y, device="cuda")
        for path in args.paths:
            config.CHOLESKY_ALGORITHM = "right" if path == "materialized" else "right_fused"
            config.CHOLESKY_FUSED_MIN_N = 0
            for what, fn in (("forward", forward), ("value+grad", value_grad)):
                r = {"n": n, "path": path, "call": what, **_reading(torch, lambda: fn(data))}
                readings.append(r)
                status = f"OUT OF MEMORY ({r['oom']})" if "oom" in r else f"{r['seconds']:.4f} s"
                print(f"[{card}] N={n} {path} {what}: {status}, peak {r['peak_gib']:.2f} GiB")
        del data
    print(json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
