"""Regression dataset container and its operations.

Counterpart of ``albatross_tpu.core.dataset``.  Features are one tensor
with leading axis N, shape ``(N,)`` or ``(N, D)``, optionally wrapped in a
``Measurement`` tag (``transform_dataset`` makes a
``LinearCombinationBatch``).  Index arithmetic that shapes the result
(deduplication, alignment) runs on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .distributions import MarginalDistribution, as_index, concatenate_marginals


def feature_count(features) -> int:
    """Leading-axis length of a feature batch (Measurement-aware)."""
    from ..kernels.features import LinearCombinationBatch, strip_measurement

    raw, _ = strip_measurement(features)
    if isinstance(raw, LinearCombinationBatch):
        return raw.size
    return raw.shape[0]


def subset_features(features, indices):
    """The rows ``indices`` of a feature batch (a Measurement stays one)."""
    from ..kernels.features import Measurement

    if isinstance(features, Measurement):
        return Measurement(subset_features(features.value, indices))
    return features[as_index(indices, features.device)]


def concatenate_features(feature_list: Sequence):
    """Concatenate feature batches along the example axis."""
    from ..kernels.features import Measurement

    if feature_list and all(isinstance(f, Measurement) for f in feature_list):
        return Measurement(concatenate_features([f.value for f in feature_list]))
    return torch.cat(list(feature_list), dim=0)


def host_array(values) -> np.ndarray:
    """Keys or indices (a tensor on any device, an array, a list) as a host
    numpy array."""
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


@dataclasses.dataclass(frozen=True)
class RegressionDataset:
    """Features + target distribution + string metadata."""

    features: torch.Tensor
    targets: MarginalDistribution
    metadata: Dict[str, str] = dataclasses.field(default_factory=dict)

    @classmethod
    def create(
        cls,
        features,
        targets,
        variance=None,
        metadata: Optional[Dict[str, str]] = None,
        device: torch.device | str | None = None,
        dtype: torch.dtype | None = None,
    ) -> "RegressionDataset":
        """Build from raw arrays; ``targets`` may be a mean vector.

        ``device``/``dtype`` place the features and targets together.  By
        default a tensor keeps its device and dtype; other features (numpy
        arrays, lists) go to the card, ``config.device(None)``, and keep
        their dtype."""
        from .. import config

        keep = device is None and isinstance(features, torch.Tensor)
        dev = features.device if keep else config.device(device)
        features = torch.as_tensor(features)
        dt = features.dtype if dtype is None else dtype
        features = features.to(device=dev, dtype=dt)
        if not isinstance(targets, MarginalDistribution):
            targets = torch.as_tensor(targets, device=dev, dtype=dt)
            if variance is not None:
                variance = torch.as_tensor(variance, device=dev, dtype=dt)
            targets = MarginalDistribution.create(targets, variance)
        n = features.shape[0]
        if targets.size != n:
            raise ValueError(f"features ({n}) and targets ({targets.size}) disagree")
        return cls(features, targets, metadata or {})

    @property
    def size(self) -> int:
        return feature_count(self.features)

    def __len__(self) -> int:
        return self.size

    def subset(self, indices) -> "RegressionDataset":
        return RegressionDataset(subset_features(self.features, indices),
                                 self.targets.subset(indices), dict(self.metadata))

    def __getitem__(self, indices) -> "RegressionDataset":
        return self.subset(torch.atleast_1d(torch.as_tensor(indices)))

    def with_metadata(self, **kwargs: str) -> "RegressionDataset":
        return RegressionDataset(self.features, self.targets, {**self.metadata, **kwargs})

    def __repr__(self):
        return f"RegressionDataset(n={self.size})"


def concatenate_datasets(datasets: Sequence[RegressionDataset]) -> RegressionDataset:
    """Concatenate along the example axis; later metadata wins."""
    metadata: Dict[str, str] = {}
    for d in datasets:
        metadata.update(d.metadata)
    return RegressionDataset(concatenate_features([d.features for d in datasets]),
                             concatenate_marginals([d.targets for d in datasets]), metadata)


def deduplicate(dataset: RegressionDataset) -> RegressionDataset:
    """Keep the last occurrence of each duplicated feature row."""
    from ..kernels.features import strip_measurement

    X = host_array(strip_measurement(dataset.features)[0])
    flat = X.reshape(X.shape[0], -1)
    keep, seen = [], set()
    for i in range(flat.shape[0] - 1, -1, -1):
        key = flat[i].tobytes()
        if key not in seen:
            seen.add(key)
            keep.append(i)
    keep.reverse()
    return dataset.subset(np.asarray(keep, dtype=np.int64))


def transform_dataset(matrix, dataset: RegressionDataset) -> RegressionDataset:
    """matrix * dataset: a linear transform of the features and targets.
    The features become LinearCombination rows, the targets A mu with
    variance diag(A Sigma A^T)."""
    from ..kernels.features import LinearCombinationBatch

    mean = dataset.targets.mean
    matrix = torch.as_tensor(matrix, dtype=mean.dtype, device=mean.device)
    features = dataset.features
    values = features[None].expand((matrix.shape[0],) + tuple(features.shape))
    variance = (matrix * matrix) @ dataset.targets.get_variance()
    return RegressionDataset(LinearCombinationBatch(values, matrix),
                             MarginalDistribution(matrix @ mean, variance), dict(dataset.metadata))


def align_datasets(a: RegressionDataset, b: RegressionDataset, key_fn):
    """Both datasets restricted to the features whose keys (``key_fn(features)
    -> array of keys``) appear in both, in sorted key order."""
    ka, kb = host_array(key_fn(a.features)).tolist(), host_array(key_fn(b.features)).tolist()
    common = sorted(set(ka) & set(kb))
    return (a.subset(np.asarray([ka.index(k) for k in common], dtype=np.int64)),
            b.subset(np.asarray([kb.index(k) for k in common], dtype=np.int64)))
