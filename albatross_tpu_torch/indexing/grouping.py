"""Split-apply-combine over datasets and feature batches.

Counterpart of ``albatross_tpu.indexing.grouping``.  Group keys and index
arrays live on the host in numpy: they decide the shapes of folds and
blocks.  The grouped values stay where they are.  ``Grouped`` iterates
in sorted key order, as the reference's std::map does.
"""

from __future__ import annotations

import inspect
from typing import Callable, Dict, Generic, List, Sequence, TypeVar

import numpy as np
import torch

from ..core.dataset import RegressionDataset, feature_count, host_array, subset_features

K = TypeVar("K")
V = TypeVar("V")


class Grouped(Generic[K, V]):
    """Ordered (sorted-key) mapping with apply / filter / combine helpers."""

    def __init__(self, items: Dict[K, V] | Sequence[tuple] = ()):
        data = dict(items)
        self._data = {k: data[k] for k in sorted(data, key=_sort_key)}

    def __getitem__(self, key: K) -> V:
        return self._data[key]

    def __contains__(self, key: K) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def items(self):
        return self._data.items()

    def keys(self) -> List[K]:
        return list(self._data.keys())

    def values(self) -> List[V]:
        return list(self._data.values())

    def get_map(self) -> Dict[K, V]:
        return dict(self._data)

    def apply(self, fn: Callable) -> "Grouped":
        """fn(value) or fn(key, value) per group, by the function's arity."""
        binary = _accepts_two_args(fn)
        return Grouped({k: fn(k, v) if binary else fn(v) for k, v in self._data.items()})

    def filter(self, predicate: Callable) -> "Grouped":
        binary = _accepts_two_args(predicate)
        return Grouped({k: v for k, v in self._data.items()
                        if (predicate(k, v) if binary else predicate(v))})

    def first_value(self) -> V:
        return next(iter(self._data.values()))

    def last_value(self) -> V:
        return next(reversed(self._data.values()))

    def first_group(self) -> tuple:
        return next(iter(self._data.items()))

    def erase(self, key: K) -> "Grouped":
        """A copy without ``key``."""
        return Grouped({k: v for k, v in self._data.items() if k != key})

    def with_(self, other) -> "Grouped":
        """Pair each value with ``other[key]``."""
        return Grouped({k: (v, other[k]) for k, v in self._data.items()})

    def counts(self) -> "Grouped":
        return self.apply(lambda v: len(v))

    def sum(self):
        return sum(self._data.values())

    def mean(self):
        return self.sum() / len(self)

    def min(self):
        return min(self._data.values())

    def max(self):
        return max(self._data.values())

    def min_value(self):
        return self.min()

    def max_value(self):
        return self.max()

    def min_key(self) -> K:
        return min(self._data.items(), key=lambda kv: kv[1])[0]

    def max_key(self) -> K:
        return max(self._data.items(), key=lambda kv: kv[1])[0]

    def any(self) -> bool:
        return any(bool(v) for v in self._data.values())

    def all(self) -> bool:
        return all(bool(v) for v in self._data.values())

    def combine(self):
        """The groups' values concatenated back into one object, in sorted
        key order: datasets, marginals and arrays concatenate; anything else
        comes back as the list of values."""
        from ..core.dataset import concatenate_datasets
        from ..core.distributions import MarginalDistribution, concatenate_marginals

        values = self.values()
        first = values[0]
        if isinstance(first, RegressionDataset):
            return concatenate_datasets(values)
        if isinstance(first, MarginalDistribution):
            return concatenate_marginals(values)
        if isinstance(first, (torch.Tensor, np.ndarray)):
            return torch.cat([torch.atleast_1d(torch.as_tensor(v)) for v in values])
        return values

    def __repr__(self):
        return f"Grouped(n_groups={len(self)})"


def _accepts_two_args(fn: Callable) -> bool:
    """Dispatch on arity, not on a caught TypeError, which would hide a
    TypeError raised inside the callback."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    params = sig.parameters.values()
    if any(p.kind == p.VAR_POSITIONAL for p in params):
        return True
    required = [p for p in params
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) and p.default is p.empty]
    return len(required) >= 2


def _sort_key(k):
    # mixed int / str keys sort by (type name, value)
    return (type(k).__name__, k)


class LeaveOneOutGrouper:
    """Every element is its own group: key = position."""

    def __call__(self, features) -> np.ndarray:
        return np.arange(feature_count(features))


class KFoldGrouper:
    """Round-robin assignment into k folds."""

    def __init__(self, k: int):
        self.k = int(k)

    def __call__(self, features) -> np.ndarray:
        return np.arange(feature_count(features)) % self.k


def compute_keys(features, grouper) -> np.ndarray:
    """The grouper's keys for a batch, as a host numpy array."""
    return host_array(grouper(features))


class GroupBy:
    """Result of group_by."""

    def __init__(self, parent, keys: np.ndarray):
        self.parent = parent
        self.keys = keys
        positions: Dict = {}
        for i, key in enumerate(keys.tolist()):  # one pass, not one per key
            positions.setdefault(key, []).append(i)
        self._indexers = Grouped({k: np.asarray(v, dtype=np.int64) for k, v in positions.items()})

    def indexers(self) -> Grouped:
        return self._indexers

    def groups(self) -> Grouped:
        if isinstance(self.parent, RegressionDataset):
            return self._indexers.apply(lambda idx: self.parent.subset(idx))
        return self._indexers.apply(lambda idx: subset_features(self.parent, idx))

    def counts(self) -> Grouped:
        return self._indexers.apply(lambda idx: int(idx.shape[0]))

    def apply(self, fn: Callable) -> Grouped:
        return self.groups().apply(fn)

    def index_apply(self, fn: Callable) -> Grouped:
        return self._indexers.apply(fn)

    def get_group(self, key):
        return self.groups()[key]

    def first_group(self) -> tuple:
        return self.groups().first_group()

    def with_(self, other) -> Grouped:
        """Per-group pairing: ``other`` is a sequence as long as the grouped
        data (split by the same indexers) or a key-aligned mapping."""
        if isinstance(other, (list, tuple)) and len(other) == len(self.keys):
            paired = self._indexers.apply(lambda idx: [other[int(i)] for i in idx])
        elif isinstance(other, (np.ndarray, torch.Tensor)) and len(other) == len(self.keys):
            tensor = torch.as_tensor(other)
            paired = self._indexers.apply(lambda idx: tensor[torch.as_tensor(idx, device=tensor.device)])
        elif isinstance(other, Grouped):
            paired = other
        else:
            paired = Grouped(other)
        return self.groups().with_(paired)

    def filter(self, predicate: Callable):
        kept = self.groups().filter(predicate)
        if isinstance(self.parent, RegressionDataset):
            return kept.combine()
        return kept


def group_by(data, grouper) -> GroupBy:
    """group_by over a RegressionDataset or a feature batch."""
    features = data.features if isinstance(data, RegressionDataset) else data
    return GroupBy(data, compute_keys(features, grouper))


def indices_complement(indices, n: int) -> np.ndarray:
    mask = np.ones(n, dtype=bool)
    mask[np.asarray(indices)] = False
    return np.nonzero(mask)[0]


def indices_from_groups(indexers: Grouped, keys: Sequence) -> np.ndarray:
    parts = [indexers[k] for k in keys]
    return np.concatenate(parts) if parts else np.zeros(0, dtype=np.int64)


def unique_values(values) -> List:
    return sorted(set(host_array(values).tolist()), key=_sort_key)


def unique_value(values):
    uniq = unique_values(values)
    if len(uniq) != 1:
        raise ValueError(f"expected exactly one unique value, got {len(uniq)}")
    return uniq[0]
