"""Move parameter values between the JAX package and this port.

The port never imports JAX: the caller hands over plain numpy values, for
example ``{k: np.asarray(p.value) for k, p in jax_model.get_params().items()}``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def params_from_numpy(model, params: Mapping[str, np.ndarray]):
    """Return ``model`` with every parameter in ``params`` set by its name
    (the JAX package's names, e.g. ``squared_exponential_length_scale``).

    Raises KeyError on a name the port's model does not have."""
    known = model.get_params()
    for name in params:
        if name not in known:
            raise KeyError(f"parameter `{name}` not found in {type(model).__name__}")
    for name, value in params.items():
        value = np.asarray(value)
        if value.ndim != 0:
            raise ValueError(f"parameter `{name}` must be a scalar, got shape {value.shape}")
        model = model.set_param_value(name, float(value))
    return model
