"""Module base for kernels, means and models.

Counterpart of ``albatross_tpu.core.module`` without the pytree
registration: a ``Module`` is a plain object whose ``Parameter``
attributes (keyed by attribute name) and child ``Module``s (also inside
tuples) are discovered by ``get_params()``, joined earlier-wins as the
reference's ``map_join`` does.  Setters return a shallow copy.
``insights`` is a string map for run metadata beside the parameters.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

from .parameters import Parameter, ParameterHandlingMixin, host_float, map_join


class Module(ParameterHandlingMixin):
    """Object with automatic parameter discovery and functional setters."""

    def _replace(self, **updates) -> "Module":
        obj = copy.copy(self)
        if "_insights" in self.__dict__:  # the copy shares the map, as the reference's does
            object.__setattr__(obj, "_insights", self.__dict__["_insights"])
        for key, value in updates.items():
            if key not in self.__dict__:
                raise AttributeError(f"{type(self).__name__} has no field {key}")
            object.__setattr__(obj, key, value)
        return obj

    @property
    def insights(self) -> Dict[str, str]:
        """Mutable string map for run metadata, created on first use; not
        model state, so never tuned, differentiated or saved in a
        checkpoint (the reference keeps it out of the pytree)."""
        if "_insights" not in self.__dict__:
            object.__setattr__(self, "_insights", {})
        return self.__dict__["_insights"]

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_insights"}

    def _own_params(self) -> Dict[str, Parameter]:
        return {
            k: v for k, v in self.__dict__.items() if isinstance(v, Parameter)
        }

    def _child_modules(self) -> Tuple[Tuple[str, "Module"], ...]:
        out = []
        for key in sorted(self.__dict__):
            v = self.__dict__[key]
            if isinstance(v, Module):
                out.append((key, v))
            elif isinstance(v, tuple):
                for i, e in enumerate(v):
                    if isinstance(e, Module):
                        out.append((f"{key}[{i}]", e))
        return tuple(out)

    def get_params(self):
        stores = [self._own_params()]
        for _, child in self._child_modules():
            stores.append(child.get_params())
        return map_join(*stores)

    def _replace_param(self, name: str, param: Parameter) -> "Module":
        if name in self._own_params():
            return self._replace(**{name: param})
        for key, child in self._child_modules():
            if name in child.get_params():
                new_child = child._replace_param(name, param)
                if "[" in key:  # tuple element
                    base, idx = key[:-1].split("[")
                    tup = list(self.__dict__[base])
                    tup[int(idx)] = new_child
                    return self._replace(**{base: tuple(tup)})
                return self._replace(**{key: new_child})
        raise KeyError(f"parameter `{name}` not found in {type(self).__name__}")

    @property
    def name(self) -> str:
        return type(self).__name__.lower()

    def __repr__(self):
        params = ", ".join(
            f"{k}={host_float(v.value):g}" for k, v in sorted(self._own_params().items())
        )
        return f"{type(self).__name__}({params})"
