"""The readings that each cell's limits are set from, on the card.

    python3 -m gpbench.calibrate --workload exact_se1d.tune --seeds 1 2 3 --control-seeds 1 2 3

For each seed this makes the cell's data, runs as many of the window's
steps as a run's check compares, and reads the check's numbers against the
float64 reference: once for the program as the configuration states it
(TF32 off, the lower readings) and, for the control seeds, once for the
control, the program in the precision below the configuration's dtype
(the upper readings): a float32 configuration's control runs the
program's own TF32 path (TF32 matmuls); a float64 configuration's runs the
program in float32 with TF32 off, on the same inputs rounded to float32.
Either is judged by the cell's own check.  One JSON line a seed and mode;
the maxima and minima last.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from gpbench.run import cache_environment

# the control of each dtype a configuration may state: (the dtype the
# program computes in, whether its TF32 path is on)
CONTROL = {"float32": ("float32", True), "float64": ("float32", False)}


def readings_for(cell, seed: int, control: bool, device: str = "cuda", detail: list | None = None) -> dict:
    """The check's numbers for the first ``samples`` steps of ``seed``'s
    window, of the program as configured or of its ``control``;
    ``detail``, where given, gets each step's raw numbers."""
    import torch

    from gpbench import check
    from gpbench.program import Program

    dtype, tf32 = CONTROL[cell.config["dtype"]] if control else (cell.config["dtype"], False)
    runs = dataclasses.replace(cell, config=dict(cell.config, dtype=dtype))
    data = cell.law.training_data(cell.config, seed, device)
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        program = Program(runs, data.to(getattr(torch, dtype)))
        loop = runs.kind.Loop(runs, program, seed)
        answers = [loop.step(loop.inputs(i)) for i in range(cell.limits["samples"])]
        program.close(loop)
    finally:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return check.readings(cell, data, answers, seed, len(answers), detail)


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
    for mode, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            detail = []
            found = readings_for(cell, seed, mode == "control", detail=detail)
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
