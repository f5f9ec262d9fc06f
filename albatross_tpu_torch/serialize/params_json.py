"""Human-readable JSON round trip for parameters and priors.

Counterpart of ``albatross_tpu.serialize.params_json``: the same JSON text
for the same parameter store (values as floats, priors tagged by class
name in the reference's variant order), so either package reads what the
other writes.  Values load as Python floats.
"""

from __future__ import annotations

import json
from typing import Dict

from ..core.parameters import Parameter, ParameterStore
from ..core.priors import PRIOR_TYPES, Prior

_TAGS = {cls.__name__: cls for cls in PRIOR_TYPES}


def prior_to_dict(prior: Prior) -> Dict:
    out = {"type": type(prior).__name__}
    for field in ("lower", "upper", "mu", "sigma"):
        if hasattr(prior, field):
            out[field] = getattr(prior, field)
    return out


def prior_from_dict(data: Dict) -> Prior:
    cls = _TAGS[data["type"]]
    return cls(**{k: v for k, v in data.items() if k != "type"})


def params_to_dict(params: ParameterStore) -> Dict:
    return {
        name: {"value": float(p.value), "prior": prior_to_dict(p.prior)}
        for name, p in sorted(params.items())
    }


def params_from_dict(data: Dict) -> ParameterStore:
    return {name: Parameter(entry["value"], prior_from_dict(entry["prior"])) for name, entry in data.items()}


def params_to_json(params: ParameterStore, indent: int = 2) -> str:
    return json.dumps(params_to_dict(params), indent=indent)


def params_from_json(text: str) -> ParameterStore:
    return params_from_dict(json.loads(text))


def save_params(path: str, model_or_params) -> None:
    params = model_or_params if isinstance(model_or_params, dict) else model_or_params.get_params()
    with open(path, "w") as f:
        f.write(params_to_json(params))


def load_params(path: str) -> ParameterStore:
    with open(path) as f:
        return params_from_json(f.read())
