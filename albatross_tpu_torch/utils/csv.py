"""CSV I/O for datasets and predictions.

Counterpart of ``albatross_tpu.utils.csv`` (the reference's
``csv_utils.hpp`` write side): the same columns and the same text for the
same values.  Reading takes the native C++ parser (``_native``, built by
``g++`` at first use) where a compiler exists, else a pure-Python path.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import _native
from ..core.dataset import RegressionDataset


def _host(values) -> np.ndarray:
    if isinstance(values, torch.Tensor):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _feature_columns(features, to_map=None) -> Dict[str, list]:
    X = _host(features)
    if to_map is not None:
        # custom per-feature -> {column: value} reflection
        rows = [to_map(X[i]) for i in range(X.shape[0])]
        names = sorted({k for row in rows for k in row})
        return {name: [row.get(name, "") for row in rows] for name in names}
    if X.ndim == 1:
        return {"feature": list(X)}
    return {f"feature_{i}": list(X[:, i]) for i in range(X.shape[1])}


def _dataset_columns(dataset, predictions, to_map) -> Dict[str, list]:
    columns = _feature_columns(dataset.features, to_map)
    columns["target"] = list(_host(dataset.targets.mean))
    if dataset.targets.variance is not None:
        columns["target_variance"] = list(_host(dataset.targets.variance))
    if predictions is not None:
        columns["prediction"] = list(_host(predictions.mean))
        columns["prediction_variance"] = list(_host(predictions.get_variance()))
    n = len(columns["target"])
    for key, value in dataset.metadata.items():
        columns[key] = [value] * n  # metadata is constant per dataset: one repeated column
    return columns


def _write_columns(path_or_stream, columns: Dict[str, list]) -> None:
    close = isinstance(path_or_stream, str)
    stream = open(path_or_stream, "w", newline="") if close else path_or_stream
    try:
        writer = csv.writer(stream)
        names = list(columns)
        writer.writerow(names)
        for i in range(len(columns[names[0]])):
            row = []
            for name in names:
                v = columns[name][i]
                row.append(repr(float(v)) if isinstance(v, (int, float, np.floating)) else str(v))
            writer.writerow(row)
    finally:
        if close:
            stream.close()


def write_to_csv(path_or_stream, dataset, predictions=None, to_map=None) -> None:
    """Dataset(s) or a raw matrix (+ optional predictions) -> CSV:

    - one ``RegressionDataset`` [+ ``MarginalDistribution`` predictions];
    - a sequence of datasets [+ matching predictions]: one concatenated CSV
      whose columns are the union of the datasets' (metadata included);
    - a bare 2-D array or tensor;
    - ``to_map``: feature row -> {column: value} custom reflection."""
    if isinstance(dataset, RegressionDataset):
        _write_columns(path_or_stream, _dataset_columns(dataset, predictions, to_map))
        return
    if isinstance(dataset, (list, tuple)):
        if predictions is not None and len(predictions) != len(dataset):
            raise ValueError(f"got {len(dataset)} datasets but {len(predictions)} prediction sets")
        preds = predictions if predictions is not None else [None] * len(dataset)
        blocks = [_dataset_columns(d, p, to_map) for d, p in zip(dataset, preds)]
        names = sorted({k for b in blocks for k in b})
        merged: Dict[str, list] = {name: [] for name in names}
        for block in blocks:
            n = len(next(iter(block.values())))
            for name in names:
                merged[name].extend(block.get(name, [""] * n))
        _write_columns(path_or_stream, merged)
        return
    X = _host(dataset)
    if X.ndim != 2:
        raise TypeError("write_to_csv expects a RegressionDataset, a sequence of them, or a 2-D array")
    _write_columns(path_or_stream, {f"col_{j}": list(X[:, j]) for j in range(X.shape[1])})


def _read_csv_python(path: str) -> Dict[str, np.ndarray]:
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = [row for row in reader if row]
    data = np.asarray(rows, dtype=np.float64)
    return {name: data[:, i] for i, name in enumerate(header)}


def read_csv_columns(path: str) -> Dict[str, np.ndarray]:
    """Column name -> f64 array, by the native parser where ``g++`` exists."""
    if _native.available():
        return _native.parse_csv(path)
    return _read_csv_python(path)


def read_csv_dataset(path: str, feature_columns: Sequence[str], target_column: str = "target",
                     variance_column: Optional[str] = None, device=None) -> RegressionDataset:
    """A dataset from CSV columns, on ``config.device(device)`` (the card
    unless the caller asks for the CPU)."""
    columns = read_csv_columns(path)
    feats = np.stack([columns[c] for c in feature_columns], axis=1)
    if feats.shape[1] == 1:
        feats = feats[:, 0]
    variance = columns[variance_column] if variance_column is not None and variance_column in columns else None
    return RegressionDataset.create(feats, columns[target_column], variance, device=device)
