"""Hyperparameter tuning drivers.

Counterpart of ``albatross_tpu.tuning.tune``.  The objective -- a metric of
(dataset, model) through the gram and the Cholesky -- is differentiable end
to end with autograd, so the default tuner is gradient based: Adam
(``torch.optim.Adam`` with optax's defaults) or L-BFGS (``torch.optim.LBFGS``
with a strong-Wolfe line search and optax's memory of 10), in the bounded,
log-scale-transformed tunable space.  A Nelder-Mead simplex in plain numpy
covers non-smooth objectives.

The tunable vector lives on the CPU in f64; the objective may compute on
the card and return a device scalar.  Adam keeps each step's value on the
device and reads a chunk of ``sync_every`` values back at once; L-BFGS
reads every value back, since its line search branches on them.  A NaN
objective counts as +inf.  ``log_fn(i, x, value)`` sees every iteration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.dataset import RegressionDataset
from ..core.parameters import ParameterStore, get_tunable_parameters, set_tunable_params


def mean_aggregator(values) -> torch.Tensor:
    """Default multi-dataset aggregator: the mean."""
    return torch.mean(torch.stack([torch.as_tensor(v) for v in values]))


@dataclasses.dataclass
class TuningResult:
    params: Optional[ParameterStore]  # filled by ModelTuner / tune_parameter_store
    value: float
    x: np.ndarray
    history: List[float]


# -- smooth bound handling ----------------------------------------------------
# The gradient path optimizes an unconstrained vector u and maps it through a
# smooth bijection into the box (two-sided bounds by a scaled sigmoid,
# one-sided by softplus shifts), so the optimizer's state never fights a clamp
# at an active bound.
_SOFTPLUS_CAP = 30.0


def _softplus(u):
    return torch.where(u > _SOFTPLUS_CAP, u, torch.log1p(torch.exp(torch.clamp(u, max=_SOFTPLUS_CAP))))


def _softplus_inv(x):
    x = torch.clamp(x, min=1e-300)
    return torch.where(x > _SOFTPLUS_CAP, x, torch.log(torch.expm1(torch.clamp(x, max=_SOFTPLUS_CAP))))


def _make_bijection(lower: torch.Tensor, upper: torch.Tensor):
    """(constrain, unconstrain) mapping R^n <-> the bound box."""
    two_sided = torch.isfinite(lower) & torch.isfinite(upper)
    lower_only = torch.isfinite(lower) & ~torch.isfinite(upper)
    upper_only = ~torch.isfinite(lower) & torch.isfinite(upper)
    span = torch.where(two_sided, upper - lower, torch.ones_like(lower))

    def constrain(u):
        x = u  # free
        x = torch.where(two_sided, lower + span * torch.sigmoid(u), x)
        x = torch.where(lower_only, lower + _softplus(u), x)
        x = torch.where(upper_only, upper - _softplus(-u), x)
        return x

    def unconstrain(x):
        x_in = torch.clamp(x, lower, upper)
        t = torch.clamp((x_in - lower) / span, 1e-12, 1.0 - 1e-12)
        u = x  # free
        u = torch.where(two_sided, torch.log(t) - torch.log1p(-t), u)
        u = torch.where(lower_only, _softplus_inv(x_in - lower), u)
        u = torch.where(upper_only, -_softplus_inv(upper - x_in), u)
        return u

    return constrain, unconstrain


def _f64(values) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.float64).detach().cpu()


def _adam_step(u, obj_u, learning_rate: float):
    """One Adam step a call, with optax's defaults; returns f(u) before the
    step, left on its device."""
    opt = torch.optim.Adam([u], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def step():
        opt.zero_grad()
        value = obj_u(u)
        value.backward()
        opt.step()
        return value.detach()

    return step


_LINE_SEARCH_TRIALS = 25


def _lbfgs_step(u, obj_u):
    """One L-BFGS iteration a call (strong-Wolfe line search, a memory of
    10 as optax's); returns f(u) before the iteration.  torch's L-BFGS
    gives the line search what is left of ``max_eval`` after the first
    evaluation: 25 trials here, its default.  Each iteration starts by
    evaluating the point its line search accepted, one of the previous
    iteration's trials: a memo of those trials hands that evaluation back
    instead of repeating it."""
    opt = torch.optim.LBFGS([u], lr=1.0, max_iter=1, max_eval=1 + _LINE_SEARCH_TRIALS, history_size=10,
                            line_search_fn="strong_wolfe")
    trials = [{}, {}]  # (value, gradient) by point: the previous iteration's, this one's

    def closure():
        key = u.detach().numpy().tobytes()
        hit = trials[1].get(key) or trials[0].get(key)
        if hit is None:
            opt.zero_grad()
            value = obj_u(u)
            value.backward()
            hit = trials[1][key] = (value.detach(), u.grad.detach().clone())
        u.grad = hit[1].clone()
        return hit[0]

    def step():
        trials[:] = [trials[1], {}]
        return torch.as_tensor(opt.step(closure)).detach()

    return step


class GenericTuner:
    """Minimize f(tunable_vector) within bounds."""

    def __init__(
        self,
        tunable,  # TunableParameters
        optimizer: str = "lbfgs",
        max_iterations: int = 200,
        learning_rate: float = 0.05,
        tolerance: float = 1e-9,
        log_fn: Optional[Callable[[int, np.ndarray, float], None]] = None,
        sync_every: int = 10,
    ):
        if optimizer not in ("adam", "lbfgs", "nelder_mead"):
            raise ValueError(f"unknown optimizer {optimizer!r}: adam, lbfgs or nelder_mead")
        self.tunable = tunable
        self.optimizer = optimizer
        self.max_iterations = max_iterations
        self.learning_rate = learning_rate
        self.tolerance = tolerance
        self.log_fn = log_fn
        self.sync_every = max(1, int(sync_every))

    def tune(self, objective: Callable) -> TuningResult:
        lower = _f64(self.tunable.lower_bounds)
        upper = _f64(self.tunable.upper_bounds)
        x0 = _f64(self.tunable.values)

        def guarded(x):
            v = objective(torch.clamp(x, lower, upper))
            return torch.where(torch.isnan(v), torch.full_like(v, math.inf), v)

        if self.optimizer == "nelder_mead":
            return self._nelder_mead(guarded, x0, lower, upper)
        return self._gradient(guarded, x0, lower, upper)

    # -- gradient path ------------------------------------------------------
    def _gradient(self, objective, x0, lower, upper) -> TuningResult:
        constrain, unconstrain = _make_bijection(lower, upper)

        def obj_u(u):
            return objective(constrain(u))

        u = unconstrain(x0).clone().requires_grad_(True)
        if self.optimizer == "adam":
            step = _adam_step(u, obj_u, self.learning_rate)
        else:
            step = _lbfgs_step(u, obj_u)

        history: List[float] = []
        best_x, best_v = x0.numpy(), math.inf
        done = 0
        converged = False
        while done < self.max_iterations and not converged:
            k = min(self.sync_every, self.max_iterations - done)
            values, xs = [], []
            for _ in range(k):
                # the value is f(u) before the step; the x logged is the
                # point after it
                values.append(step())
                with torch.no_grad():
                    xs.append(constrain(u).numpy().copy())
            values = torch.stack(values).cpu().tolist()  # the chunk's one read-back
            for j in range(k):
                i = done + j
                v = float(values[j])
                history.append(v)
                if self.log_fn:
                    self.log_fn(i, xs[j], v)
                if v < best_v:
                    best_v, best_x = v, xs[j]
                if i > 5 and abs(history[-2] - v) < self.tolerance * (1 + abs(v)):
                    converged = True
                    break
            done += k
        with torch.no_grad():
            final_v = float(obj_u(u))
            if final_v < best_v:
                best_v, best_x = final_v, constrain(u).numpy().copy()
        return TuningResult(None, best_v, best_x, history)

    # -- simplex path -------------------------------------------------------
    def _nelder_mead(self, objective, x0, lower, upper) -> TuningResult:
        def f(x):
            with torch.no_grad():
                return float(objective(torch.as_tensor(x, dtype=torch.float64)))

        x0 = x0.numpy().astype(float)
        lower_np = lower.numpy()
        upper_np = upper.numpy()
        n = x0.shape[0]
        # initial simplex: perturb each coordinate
        scale = np.where(np.isfinite(upper_np - lower_np), 0.05 * (upper_np - lower_np), 0.1)
        scale = np.maximum(scale, 1e-4)
        simplex = [x0]
        for i in range(n):
            v = x0.copy()
            v[i] = np.clip(v[i] + scale[i], lower_np[i], upper_np[i])
            if v[i] == x0[i]:
                v[i] = np.clip(x0[i] - scale[i], lower_np[i], upper_np[i])
            simplex.append(v)
        simplex = np.stack(simplex)
        values = np.array([f(v) for v in simplex])
        history: List[float] = []
        alpha, gamma, rho, sigma = 1.0, 2.0, 0.5, 0.5

        def clipped(x):
            return np.clip(x, lower_np, upper_np)

        for it in range(self.max_iterations):
            order = np.argsort(values)
            simplex, values = simplex[order], values[order]
            history.append(values[0])
            if self.log_fn:
                self.log_fn(it, simplex[0], values[0])
            if abs(values[-1] - values[0]) < self.tolerance * (1 + abs(values[0])):
                break
            centroid = simplex[:-1].mean(axis=0)
            xr = clipped(centroid + alpha * (centroid - simplex[-1]))
            fr = f(xr)
            if values[0] <= fr < values[-2]:
                simplex[-1], values[-1] = xr, fr
            elif fr < values[0]:
                xe = clipped(centroid + gamma * (xr - centroid))
                fe = f(xe)
                if fe < fr:
                    simplex[-1], values[-1] = xe, fe
                else:
                    simplex[-1], values[-1] = xr, fr
            else:
                xc = clipped(centroid + rho * (simplex[-1] - centroid))
                fc = f(xc)
                if fc < values[-1]:
                    simplex[-1], values[-1] = xc, fc
                else:
                    for i in range(1, n + 1):
                        simplex[i] = clipped(simplex[0] + sigma * (simplex[i] - simplex[0]))
                        values[i] = f(simplex[i])
        best = int(np.argmin(values))
        return TuningResult(None, float(values[best]), simplex[best], history)


class ModelTuner:
    """Ties model + metric + dataset(s) into a tunable objective."""

    def __init__(
        self,
        model,
        metric,
        datasets: Sequence[RegressionDataset] | RegressionDataset,
        aggregator: Callable = mean_aggregator,
        **tuner_kwargs,
    ):
        self.model = model
        self.metric = metric
        self.datasets = [datasets] if isinstance(datasets, RegressionDataset) else list(datasets)
        self.aggregator = aggregator
        self.tuner_kwargs = tuner_kwargs

    def objective(self, x):
        model = self.model.set_tunable_params(x)
        values = [self.metric(d, model) for d in self.datasets]
        return self.aggregator(values) if len(values) > 1 else values[0]

    def tune(self) -> TuningResult:
        tuner = GenericTuner(self.model.get_tunable_parameters(), **self.tuner_kwargs)
        result = tuner.tune(self.objective)
        result.params = set_tunable_params(self.model.get_params(), torch.as_tensor(result.x))
        return result

    def tuned_model(self):
        result = self.tune()
        return self.model.set_params(result.params), result


def get_tuner(model, metric, dataset, **kwargs) -> ModelTuner:
    return ModelTuner(model, metric, dataset, **kwargs)


def tune_parameter_store(
    objective: Callable[[ParameterStore], object],
    params: ParameterStore,
    **tuner_kwargs,
) -> TuningResult:
    """Tune an f(ParameterStore) objective: the store's tunable vector is
    optimized and the result carries the updated store."""
    tuner = GenericTuner(get_tunable_parameters(params), **tuner_kwargs)
    result = tuner.tune(lambda x: objective(set_tunable_params(params, x)))
    result.params = set_tunable_params(params, torch.as_tensor(result.x))
    return result
