"""Cross-validation folds.

Counterpart of ``albatross_tpu.evaluation.folds``: a fold is a train/test
split of a dataset by host-side index arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..core.dataset import RegressionDataset
from ..indexing.grouping import Grouped, KFoldGrouper, LeaveOneOutGrouper, group_by, indices_complement


@dataclasses.dataclass(frozen=True)
class RegressionFold:
    """Train/test split for one fold."""

    train_dataset: RegressionDataset
    test_dataset: RegressionDataset
    test_indices: np.ndarray
    key: Any = None


def create_fold(dataset: RegressionDataset, test_indices, key=None) -> RegressionFold:
    """The test indices against their complement."""
    test_indices = np.asarray(test_indices)
    train_indices = indices_complement(test_indices, dataset.size)
    return RegressionFold(dataset.subset(train_indices), dataset.subset(test_indices), test_indices, key)


def folds_from_group_indexer(dataset: RegressionDataset, indexers: Grouped) -> Grouped:
    """One fold per group."""
    return indexers.apply(lambda key, idx: create_fold(dataset, idx, key=key))


def folds_from_grouper(dataset: RegressionDataset, grouper) -> Grouped:
    return folds_from_group_indexer(dataset, group_by(dataset, grouper).indexers())


def leave_one_out_folds(dataset: RegressionDataset) -> Grouped:
    return folds_from_grouper(dataset, LeaveOneOutGrouper())


def k_fold_folds(dataset: RegressionDataset, k: int) -> Grouped:
    return folds_from_grouper(dataset, KFoldGrouper(k))
