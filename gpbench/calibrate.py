"""The readings that each cell's limits are set from, on the card.

    python3 -m gpbench.calibrate --workload exact_se1d.tune --seeds 1 2 3 --control-seeds 1 2 3

For each seed this makes the cell's data, runs as many of the window's
steps as a run's check compares, and reads the check's numbers against the
float64 reference: once for the program as the configuration states it
(TF32 off, the lower readings) and, for the control seeds, once with the
program's own TF32 path switched on (TF32 matmuls, the precision below
float32; the upper readings).  One JSON line a seed and mode; the maxima
and minima last.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gpbench.run import cache_environment


def readings_for(cell, seed: int, tf32: bool, device: str = "cuda", detail: list | None = None) -> dict:
    """The check's numbers for the first ``samples`` steps of ``seed``'s
    window, with the program's TF32 path on or off; ``detail``, where
    given, gets each step's raw numbers."""
    import torch

    from gpbench import check, generator
    from gpbench.program import Program

    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        x, y = generator.training_data(cell.config, seed, device)
        program = Program(cell, x, y)
        loop = cell.kind.Loop(cell, program, seed)
        answers = [loop.step(loop.inputs(i)) for i in range(cell.limits["samples"])]
        program.close(loop)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return check.readings(cell, x, y, answers, seed, len(answers), detail)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    cache_environment()
    from gpbench import spec

    cell = spec.load_cell(args.workload)
    lowest, highest = {}, {}
    for mode, seeds in (("program", args.seeds), ("tf32", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            detail = []
            found = readings_for(cell, seed, mode == "tf32", detail=detail)
            print(json.dumps({"workload": cell.name, "mode": mode, "seed": seed, "readings": found,
                              "seconds": time.perf_counter() - t, "detail": detail}), flush=True)
            for name, value in found.items():
                if mode == "program":
                    highest[name] = max(highest.get(name, 0.0), value)
                else:
                    lowest[name] = min(lowest.get(name, float("inf")), value)
    print(json.dumps({"workload": cell.name, "lower_readings": highest, "control_least": lowest,
                      "limits": cell.limits["limits"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
