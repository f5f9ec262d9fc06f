"""Run one cell of the benchmark once, on the card this process starts on.

    python3 -m gpbench.run --workload exact_se1d.tune --seed 7 --seconds 40 --trace 0

Set-up makes the cell's data from the seed by the configuration's data
law (``data/<law>.py``), builds the model through the port's public API and runs two warm-up steps of the cell's own shapes (the
first run in a checkout also builds the port's kernels into
``build/kernels/``).  The window then runs the traffic mix's closed loop
for ``--seconds``.  ``--trace 0`` reports the cell's end-to-end metrics;
``--trace 1`` runs the same window, then a short profiled span and the
per-layer readers, and reports the per-layer metrics.  Last, the program's
state is freed and a seeded sample of the window's answers is worked out
again by the float64 reference; ``correct`` says whether every number
compared is within its limit.  The result is the last line of standard
output; the numbers compared, with their limits, are the last lines of
standard error.

Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, the run prints no
result and exits with a code other than 0.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: imports, build, data, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "albatross_tpu")
WARMUP_STEPS = 2
TRACE_SPAN_S = 2.0  # the profiled span: at least this long and 3 steps


def cache_environment(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds.  The port builds its
    kernels into ``build/kernels/`` beside its package.  Python's own
    bytecode goes to ``build/pycache/``: where the installed packages carry
    none and the environment forbids writing it, every run would compile
    torch's and sympy's sources again (about 5 s, swinging with the host's
    load)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float) -> tuple[dict, list]:
    """(the result line's object, the check's lines) of one run of
    ``cell`` (a ``spec.Cell``) on ``device``.  Off the card the same path
    runs with the port's plain versions (for tests at small sizes), and no
    device metric is read."""
    import torch

    from gpbench import check, generator
    from gpbench import trace as tracing
    from gpbench.program import Program
    from gpbench.readings import Context, Window
    from gpbench.spec import reader

    config = cell.config
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    marks = [("imports", time.perf_counter())]
    data = cell.law.training_data(config, seed, device)
    sync()
    marks.append(("data", time.perf_counter()))
    program = Program(cell, data)
    loop = cell.kind.Loop(cell, program, seed)
    sync()
    marks.append(("model", time.perf_counter()))
    for k in range(WARMUP_STEPS):
        loop.step(loop.inputs(k, generator.WARMUP))
    sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_peak = torch.cuda.max_memory_allocated() if on_card else None
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    log("set-up: " + ", ".join(f"{name} {t - before:.3f} s" for (name, t), before
                               in zip(marks, [t_start] + [t for _, t in marks[:-1]])))
    deadline = t0 + seconds
    steps, answers = [], []
    while time.perf_counter() < deadline:
        step_input = loop.inputs(len(steps))
        t_call = time.perf_counter()
        answers.append(loop.step(step_input))
        steps.append((t_call, time.perf_counter()))
    window_peak = torch.cuda.max_memory_allocated() if on_card else None
    completed = [s for s in steps if s[1] <= deadline]
    window = Window(t0, completed)
    failed = sum(1 for a in answers if not loop.finite(a))

    summary = None
    if trace and on_card:
        per_step = window.seconds / max(1, len(completed))
        count = max(3, math.ceil(TRACE_SPAN_S / per_step))
        summary = tracing.profile_steps(lambda k: loop.step(loop.inputs(len(steps) + k)), count)
        log(f"traced span: {count} steps, {summary['window_s']:.4f} s, busy {summary['busy_s']:.4f} s, "
            f"{summary['launches']} launches, reduced in {summary['reduce_s']:.2f} s")
    ctx = Context(cell.name, config, cell.traffic, seed, setup_s, window, window_peak, summary, program,
                  cell.model)
    metrics = {}
    for metric in (cell.per_layer if trace else cell.end_to_end):
        value = reader(metric["name"], cell.here).read(ctx)
        if value is None:
            if on_card and not trace:
                raise RuntimeError(f"the end-to-end metric {metric['name']} read nothing")
            continue
        metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    log(f"{cell.name} seed {seed}: set-up {setup_s:.3f} s, {len(completed)} of {len(steps)} steps in the "
        f"window, {window.seconds:.3f} s; " + ", ".join(f"{k} {v['value']!r}" for k, v in metrics.items()))

    del ctx
    program.close(loop)
    t = time.perf_counter()
    found = check.readings(cell, data, answers[:len(completed)] or answers, seed, cell.limits["samples"])
    correct, table = check.verdict(found, cell.limits["limits"])
    correct = correct and failed == 0
    log(f"check: {min(len(steps), cell.limits['samples'])} answers against the float64 reference in "
        f"{time.perf_counter() - t:.2f} s")

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": max(setup_peak, window_peak) if on_card else 0}
    result = {"correct": correct, "attempted": len(steps), "failed": failed, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"], device_info["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["check"] = table
    lines = [f"check {name} {row['value']!r} limit {row['limit']!r}" for name, row in table.items()]
    lines.append(f"check failed_steps {failed} limit 0")
    lines.append(f"check correct {'true' if correct else 'false'}")
    return result, lines


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True, help="a workload name of BENCHMARK.json")
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_environment()
    import torch

    if not torch.cuda.is_available():
        log("no CUDA card: torch.cuda.is_available() is False; no result")
        return 2
    from gpbench import spec

    cell = spec.load_cell(args.workload)
    if torch.cuda.device_count() < cell.workload["chips"]:
        log(f"{args.workload} needs {cell.workload['chips']} cards, this machine has "
            f"{torch.cuda.device_count()}; no result")
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package is loaded: {found}; no result")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
