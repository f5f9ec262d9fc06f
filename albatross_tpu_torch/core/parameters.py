"""Parameters, parameter stores and the get/set protocol.

Counterpart of ``albatross_tpu.core.parameters``.  A ``Parameter`` is a
value (a float or a 0-d tensor) and a prior.  A ``ParameterStore`` is a
plain ``dict[str, Parameter]`` iterated sorted by name, as the reference's
``std::map`` is.  Setters are functional: they return a new object and
leave the old one untouched.

The tunable round trip (``get_tunable_parameters`` / ``set_tunable_params``)
skips fixed parameters and log-transforms log-scale ones, as the JAX package
does.  The tunable vector is an f64 tensor; values set from a vector ``x``
are its elements (exponentiated and clamped as needed), so they keep
``x``'s autograd graph and device: a tuner differentiates a model's
objective with respect to ``x``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping

import torch

from .priors import FixedPrior, Prior, UninformativePrior

ParameterStore = Dict[str, "Parameter"]


def host_float(value) -> float:
    """A scalar value (float or 0-d tensor, possibly requiring grad) as a
    host float, for host-side guards and launch arguments."""
    return float(value.detach()) if isinstance(value, torch.Tensor) else float(value)


@dataclasses.dataclass(frozen=True)
class Parameter:
    """A scalar model parameter: value + prior."""

    value: torch.Tensor | float = 0.0
    prior: Prior = dataclasses.field(default_factory=UninformativePrior)

    @property
    def is_fixed(self) -> bool:
        return self.prior.is_fixed

    def within_bounds(self) -> bool:
        v = host_float(self.value)
        return self.prior.lower_bound <= v <= self.prior.upper_bound

    def is_valid(self) -> bool:
        return self.within_bounds()

    def prior_log_likelihood(self) -> torch.Tensor:
        return self.prior.log_pdf(self.value)

    def with_value(self, value) -> "Parameter":
        return Parameter(value, self.prior)

    def with_prior(self, prior: Prior) -> "Parameter":
        return Parameter(self.value, prior)

    def fixed(self) -> "Parameter":
        return Parameter(self.value, FixedPrior())


def _as_f64(value) -> torch.Tensor:
    """A tensor as it is (dtype, device, graph kept); anything else as f64."""
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(value, dtype=torch.float64)


@dataclasses.dataclass
class TunableParameters:
    """Flattened view of the non-fixed parameters, sorted by name."""

    names: List[str]
    values: torch.Tensor  # f64, log-scale entries log-transformed
    lower_bounds: torch.Tensor
    upper_bounds: torch.Tensor


def get_tunable_parameters(params: ParameterStore) -> TunableParameters:
    """Flatten the non-fixed parameters to an f64 vector, sorted by name.

    Log-scale parameters are log-transformed (values and bounds); a value
    outside its bounds raises, as in the JAX package.  Tensor values keep
    their autograd graph and move to the CPU."""
    names, values, lowers, uppers = [], [], [], []
    for name in sorted(params):
        p = params[name]
        if p.is_fixed:
            continue
        lb, ub = p.prior.lower_bound, p.prior.upper_bound
        fv = host_float(p.value)
        if fv < lb:
            raise ValueError(f"INVALID PARAMETER: {name} expected to be greater than {lb} but is: {fv}")
        if fv > ub:
            raise ValueError(f"INVALID PARAMETER: {name} expected to be less than {ub} but is: {fv}")
        v = _as_f64(p.value).to(device="cpu", dtype=torch.float64)
        if p.prior.is_log_scale:
            v = torch.log(v)
            lb = math.log(lb) if lb > 0 else -math.inf
            ub = math.log(ub) if ub < math.inf else math.inf
        names.append(name)
        values.append(v)
        lowers.append(lb)
        uppers.append(ub)
    return TunableParameters(
        names=names,
        values=torch.stack(values) if values else torch.zeros((0,), dtype=torch.float64),
        lower_bounds=torch.tensor(lowers, dtype=torch.float64),
        upper_bounds=torch.tensor(uppers, dtype=torch.float64),
    )


def ensure_value_within_bounds(param: Parameter, value):
    """Clamp to the prior's bounds."""
    return torch.clamp(_as_f64(value), param.prior.lower_bound, param.prior.upper_bound)


def set_tunable_params(params: ParameterStore, x, force_bounds: bool = True) -> ParameterStore:
    """Inverse of get_tunable_parameters.

    ``x`` is a vector ordered by sorted non-fixed parameter name (a tensor
    keeps its dtype, device and graph; anything else becomes f64);
    log-scale entries are exponentiated back; values are clamped into
    bounds unless ``force_bounds`` is False."""
    x = _as_f64(x)
    tunable = [name for name in sorted(params) if not params[name].is_fixed]
    if x.shape[0] != len(tunable):
        raise ValueError(f"expected {len(tunable)} tunable values, got {x.shape[0]}")
    out = dict(params)
    for i, name in enumerate(tunable):
        p = params[name]
        v = x[i]
        if p.prior.is_log_scale:
            v = torch.exp(v)
        if force_bounds:
            v = ensure_value_within_bounds(p, v)
        out[name] = p.with_value(v)
    return out


def params_are_valid(params: ParameterStore) -> bool:
    return all(p.is_valid() for p in params.values())


def parameter_prior_log_likelihood(params: ParameterStore) -> torch.Tensor:
    """Sum of prior log-pdfs over the store, in f64."""
    total = torch.zeros((), dtype=torch.float64)
    for name in sorted(params):
        total = total + params[name].prior_log_likelihood().to(torch.float64).cpu()
    return total


def map_join(*stores: Mapping[str, Parameter]) -> ParameterStore:
    """Join parameter maps; earlier stores win on duplicate names."""
    out: ParameterStore = {}
    for store in stores:
        for k, v in store.items():
            out.setdefault(k, v)
    return out


def pretty_params(params: ParameterStore) -> str:
    """Copy-pasteable dump of the values, sorted by name."""
    lines = ["{"]
    for name in sorted(params):
        lines.append(f'    {{"{name}", {host_float(params[name].value):.12e}}},')
    lines.append("};")
    return "\n".join(lines) + "\n"


def pretty_priors(params: ParameterStore) -> str:
    lines = ["PRIORS:"]
    for name in sorted(params):
        lines.append(f'    "{name}": {params[name].prior.name}')
    return "\n".join(lines) + "\n"


def pretty_param_details(params: ParameterStore) -> str:
    if not params:
        return ""
    width = max(len(n) for n in params) + 1
    lines = []
    for name in sorted(params):
        p = params[name]
        lines.append(
            f"    {name:<{width}} value: {host_float(p.value):<12g} "
            f"valid: {str(p.is_valid()):<5} prior: {p.prior.name:<15} "
            f"bounds: [{p.prior.lower_bound}, {p.prior.upper_bound}]"
        )
    return "\n".join(lines) + "\n"


class ParameterHandlingMixin:
    """get/set-param protocol shared by kernels, means and models.

    Implementors define ``get_params()`` and ``_replace_param(name,
    Parameter) -> Self``; every setter returns a new object."""

    def get_params(self) -> ParameterStore:  # pragma: no cover - interface
        raise NotImplementedError

    def _replace_param(self, name: str, param: Parameter):  # pragma: no cover
        raise NotImplementedError

    def get_param_names(self) -> List[str]:
        return sorted(self.get_params())

    def get_param_value(self, name: str):
        return self.get_params()[name].value

    def params_are_valid(self) -> bool:
        return params_are_valid(self.get_params())

    def prior_log_likelihood(self) -> torch.Tensor:
        return parameter_prior_log_likelihood(self.get_params())

    def get_tunable_parameters(self) -> TunableParameters:
        return get_tunable_parameters(self.get_params())

    def set_param(self, name: str, param):
        if name not in self.get_params():
            raise KeyError(f"parameter `{name}` not found")
        if not isinstance(param, Parameter):
            param = self.get_params()[name].with_value(param)
        return self._replace_param(name, param)

    def set_param_value(self, name: str, value):
        if name not in self.get_params():
            raise KeyError(f"parameter `{name}` not found")
        return self.set_param(name, self.get_params()[name].with_value(value))

    def set_param_prior(self, name: str, prior: Prior):
        return self.set_param(name, self.get_params()[name].with_prior(prior))

    def set_params(self, params: Mapping[str, Parameter]):
        obj = self
        for name, p in params.items():
            obj = obj.set_param(name, p)
        return obj

    def set_param_values(self, values: Mapping[str, object]):
        obj = self
        for name, v in values.items():
            obj = obj.set_param_value(name, v)
        return obj

    def set_param_if_exists(self, name: str, param):
        if name in self.get_params():
            return self.set_param(name, param)
        return self

    def set_param_values_if_exists(self, values: Mapping[str, object]):
        obj = self
        for name, v in values.items():
            obj = obj.set_param_if_exists(name, v)
        return obj

    def set_tunable_params(self, x, force_bounds: bool = True):
        return self.set_params(set_tunable_params(self.get_params(), x, force_bounds))

    def pretty_params(self) -> str:
        return pretty_params(self.get_params())

    def pretty_param_details(self) -> str:
        return pretty_param_details(self.get_params())
