"""Regression dataset container and its operations.

Counterpart of ``albatross_tpu.core.dataset``.  Features are one tensor
with leading axis N, shape ``(N,)`` or ``(N, D)``, or a structured batch:
a ``TaggedBatch`` of mixed feature kinds, a ``LinearCombinationBatch``
(``transform_dataset`` makes one), a ``ConstantTerm``; any of them may be
wrapped in a ``Measurement`` tag.  Index arithmetic that shapes the result
(deduplication, alignment, tagged subsets) runs on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .distributions import MarginalDistribution, as_index, concatenate_marginals


def first_leaf(features) -> torch.Tensor:
    """The first tensor of a feature batch, as the JAX package's
    ``tree_leaves(features)[0]``: the tensor itself, a Measurement's or a
    TaggedBatch's first sub-batch's, a LinearCombinationBatch's values, a
    ConstantTerm's marker."""
    from ..kernels.features import LinearCombinationBatch, Measurement
    from ..kernels.polynomials import ConstantTerm
    from ..kernels.variants import TaggedBatch

    if isinstance(features, Measurement):
        return first_leaf(features.value)
    if isinstance(features, TaggedBatch):
        return first_leaf(features.features[0])
    if isinstance(features, LinearCombinationBatch):
        return features.values
    if isinstance(features, ConstantTerm):
        return features.marker
    return features


def float_like(features) -> dict:
    """``dtype`` and ``device`` keywords for a tensor built from a feature
    batch: its first tensor's device, and its dtype when that is a float
    type (integer ids give the default float dtype)."""
    leaf = first_leaf(features)
    dtype = leaf.dtype if leaf.is_floating_point() else torch.get_default_dtype()
    return {"dtype": dtype, "device": leaf.device}


def feature_count(features) -> int:
    """Leading-axis length of a feature batch; the wrappers (Measurement,
    TaggedBatch, LinearCombinationBatch, ConstantTerm) report their own
    size."""
    from ..kernels.features import LinearCombinationBatch, strip_measurement
    from ..kernels.polynomials import ConstantTerm
    from ..kernels.variants import TaggedBatch

    raw, _ = strip_measurement(features)
    if isinstance(raw, (LinearCombinationBatch, TaggedBatch, ConstantTerm)):
        return raw.size
    return raw.shape[0]


def subset_features(features, indices):
    """The rows ``indices`` of a feature batch (a Measurement stays one; a
    TaggedBatch is subset by its interleaved positions)."""
    from ..kernels.features import Measurement
    from ..kernels.variants import TaggedBatch

    if isinstance(features, Measurement):
        return Measurement(subset_features(features.value, indices))
    if isinstance(features, TaggedBatch):
        return features.subset(host_array(indices))
    return features[as_index(indices, features.device)]


def concatenate_features(feature_list: Sequence):
    """Concatenate feature batches along the example axis; TaggedBatches
    concatenate tag by tag, keeping the interleaved order."""
    from ..kernels.features import Measurement
    from ..kernels.variants import TaggedBatch

    if feature_list and all(isinstance(f, Measurement) for f in feature_list):
        return Measurement(concatenate_features([f.value for f in feature_list]))
    if feature_list and all(isinstance(f, TaggedBatch) for f in feature_list):
        return TaggedBatch.concatenate(list(feature_list))
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

    features: Any
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
        their dtype.  A TaggedBatch or LinearCombinationBatch keeps its
        tensors; the targets go to its first tensor's device and float
        dtype unless ``device``/``dtype`` say otherwise."""
        from .. import config
        from ..kernels.features import LinearCombinationBatch
        from ..kernels.variants import TaggedBatch

        if isinstance(features, (TaggedBatch, LinearCombinationBatch)):
            like = float_like(features)
            dev = like["device"] if device is None else config.device(device)
            dt = like["dtype"] if dtype is None else dtype
        else:
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
        n = feature_count(features)
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
