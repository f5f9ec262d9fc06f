"""Regression dataset container.

Counterpart of ``albatross_tpu.core.dataset``.  Features are one tensor
with leading axis N, shape ``(N,)`` or ``(N, D)``, optionally wrapped in a
``Measurement`` tag.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .distributions import MarginalDistribution


def feature_count(features) -> int:
    """Leading-axis length of a feature batch (Measurement-aware)."""
    from ..kernels.features import strip_measurement

    raw, _ = strip_measurement(features)
    return raw.shape[0]


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

        ``device``/``dtype`` (default: those of ``features``) place the
        features and targets together."""
        from .. import config

        features = torch.as_tensor(features)
        dev = features.device if device is None else config.device(device)
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

    def __repr__(self):
        return f"RegressionDataset(n={self.size})"
