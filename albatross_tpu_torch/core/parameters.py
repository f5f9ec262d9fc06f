"""Parameters, parameter stores and the get/set protocol.

Counterpart of ``albatross_tpu.core.parameters``.  A ``Parameter`` is a
value (a float or a 0-d tensor) and a prior.  A ``ParameterStore`` is a
plain ``dict[str, Parameter]`` iterated sorted by name, as the reference's
``std::map`` is.  Setters are functional: they return a new object and
leave the old one untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping

import torch

from .priors import FixedPrior, Prior, UninformativePrior

ParameterStore = Dict[str, "Parameter"]


@dataclasses.dataclass(frozen=True)
class Parameter:
    """A scalar model parameter: value + prior."""

    value: torch.Tensor | float = 0.0
    prior: Prior = dataclasses.field(default_factory=UninformativePrior)

    @property
    def is_fixed(self) -> bool:
        return self.prior.is_fixed

    def within_bounds(self) -> bool:
        v = float(self.value)
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
