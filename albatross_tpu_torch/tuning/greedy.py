"""Greedy coordinate-descent coarse tuner.

Counterpart of ``albatross_tpu.tuning.greedy``: per parameter, log-spaced
candidates within the prior's bounds, keep the best, sweep again.  The JAX
package evaluates one parameter's candidates as one ``vmap`` batch; here
they go through a loop (``use_vmap`` is kept in the signature and changes
nothing).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..core.parameters import set_tunable_params


def _candidate_values(value, lower, upper, n: int) -> np.ndarray:
    """Log-spaced candidates within bounds around the current value."""
    lo = lower if np.isfinite(lower) and lower > 0 else max(1e-8, value * 1e-4)
    hi = upper if np.isfinite(upper) else max(1.0, value * 1e4)
    if lo <= 0 or hi <= lo:
        return np.linspace(
            lower if np.isfinite(lower) else value - 1.0,
            upper if np.isfinite(upper) else value + 1.0,
            n,
        )
    return np.geomspace(lo, hi, n)


def greedy_tune(
    model,
    objective: Callable,
    n_candidates: int = 9,
    n_sweeps: int = 2,
    use_vmap: bool = True,
    log_fn: Optional[Callable] = None,
):
    """Minimize objective(model) coordinate-wise.

    ``objective(model) -> scalar``.  Returns (best_model, best_value)."""
    tunable = model.get_tunable_parameters()
    x = tunable.values.detach().numpy().astype(float)
    lower = tunable.lower_bounds.numpy()
    upper = tunable.upper_bounds.numpy()
    params = model.get_params()

    def eval_x(xv) -> float:
        with torch.no_grad():
            return float(objective(model.set_params(set_tunable_params(params, torch.as_tensor(xv)))))

    best_value = eval_x(x)
    for sweep in range(n_sweeps):
        for i, name in enumerate(tunable.names):
            # candidates in tunable space: log-scale parameters are already
            # log-transformed there
            cands = _candidate_values(x[i], lower[i], upper[i], n_candidates)
            cand_x = np.tile(x, (len(cands), 1))
            cand_x[:, i] = np.clip(cands, lower[i], upper[i])
            values = np.asarray([eval_x(c) for c in cand_x])
            values = np.where(np.isnan(values), np.inf, values)
            j = int(np.argmin(values))
            if values[j] < best_value:
                best_value = float(values[j])
                x = cand_x[j]
            if log_fn:
                log_fn(sweep, name, x[i], best_value)

    best_model = model.set_params(set_tunable_params(params, torch.as_tensor(x)))
    return best_model, best_value
